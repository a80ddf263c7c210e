"""Port checks of the hw link stream (mode="hw", the default) on the CPU.

round_tpu's hw mode draws from the TPU's hardware PRNG, which neither this
CPU nor the card can reproduce, so the port's hw mode is held against
round_tpu by statistics (decision health on one numpy-made mix against
round_tpu's hash run), and within the port bit for bit: the per-round
engine against the whole-run loop, K2's plain version against a dense
construction from P2's stream, the keep rule's frequencies."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.ops import fused as jfused
from round_tpu.utils import benchstat as jbenchstat
from round_tpu_torch import interop
from round_tpu_torch.apps import ladder
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.models.benor import BenOrState
from round_tpu_torch.models.floodmin import FloodMinState
from round_tpu_torch.models.otr import OtrState
from round_tpu_torch.ops import fused as tfused
from round_tpu_torch.utils import benchstat as tbenchstat

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

M32 = 0xFFFFFFFF
LOOP_ARGS = ("crashed", "side", "crash_round", "heal_round", "rotate_down",
             "p8", "salt0", "salt1")


def _np_mix(seed, S, n, p8, f=0, parts=False):
    """A FaultMix as numpy arrays: f crashed lanes per scenario from round
    1, uniform drop threshold(s) p8, and with `parts` a two-way partition
    healing at round 3."""
    rng = np.random.default_rng(seed)
    crashed = np.argsort(rng.random((S, n)), axis=1) < f
    side = (rng.random((S, n)) < 0.5).astype(np.int32) if parts else \
        np.zeros((S, n), np.int32)
    return {
        "crashed": crashed, "crash_round": np.ones((S,), np.int32),
        "side": side, "heal_round": np.full((S,), 3 if parts else 0,
                                            np.int32),
        "rotate_down": np.zeros((S,), np.int32),
        "p8": np.resize(np.asarray(p8, np.int32), S),
        "salt0": rng.integers(0, 2**32, S, dtype=np.uint32).view(np.int32),
        "salt1": rng.integers(0, 2**32, S, dtype=np.uint32).view(np.int32),
    }


def test_hw_keep_fraction_and_diagonal():
    """P(keep) = 1 - p8/256 within 4 standard deviations over every
    off-diagonal link of 4 rounds at n=256; the diagonal is never kept;
    p8 <= 0 keeps every other link."""
    n, rounds = 256, 4
    p8 = torch.tensor([0, 1, 13, 64, 128, 255], dtype=torch.int32)
    gen = torch.Generator().manual_seed(5)
    salt0 = tfast._salts(gen, 6, 0, "cpu")
    salt1 = tfast._salts(gen, 6, 1, "cpu")
    kept = torch.zeros(6, dtype=torch.float64)
    eye = torch.eye(n, dtype=torch.bool)
    for r in range(rounds):
        salt1r = tfused._i32(r * tfused._RMIX + tfused._u32(salt1))
        keep = tfused._keep_mask(n, "hw", salt0, salt1r, p8)
        assert not bool(keep[:, eye].any())
        kept += keep.sum((1, 2)).to(torch.float64)
    links = rounds * (n * n - n)
    for s in range(6):
        p = 1 - min(int(p8[s]), 256) / 256 if p8[s] > 0 else 1.0
        frac = float(kept[s]) / links
        sigma = math.sqrt(p * (1 - p) / links)
        assert abs(frac - p) <= 4 * sigma + 1e-12, (int(p8[s]), frac, p)


def test_hw_draws_are_bytes_of_the_p2_stream():
    """Link idx = j*n + i draws byte idx & 3 of element idx >> 2 of the
    stream keyed (salt0, salt1r), n=20 so a Philox block straddles two
    receivers' rows."""
    n = 20
    salt0 = torch.tensor([7, -3], dtype=torch.int32)
    salt1r = torch.tensor([-100, 12345], dtype=torch.int32)
    draws = tfused._hw_draws(n, salt0, salt1r)
    for s in range(2):
        words = tfused.philox_bits(torch.stack([salt0[s], salt1r[s]]),
                                   ((n * n + 3) // 4,))
        words = [w & M32 for w in words.tolist()]
        want = [(words[idx >> 2] >> (8 * (idx & 3))) & 0xFF
                for idx in range(n * n)]
        assert draws[s].reshape(-1).tolist() == want


def test_hw_stream_is_keyed_by_both_salts():
    n = 32
    p8 = torch.tensor([128, 128, 128])
    s0 = torch.tensor([1, 2, 1], dtype=torch.int32)
    s1 = torch.tensor([9, 9, 10], dtype=torch.int32)
    keep = tfused._keep_mask(n, "hw", s0, s1, p8)
    assert not torch.equal(keep[0], keep[1])
    assert not torch.equal(keep[0], keep[2])


@pytest.mark.parametrize("with_side", [False, True])
def test_hw_hist_exchange_matches_dense_construction(with_side):
    """K2's plain version in hw mode against counts built densely from the
    keep rule over P2's stream."""
    S, n, V = 7, 24, 5
    rng = np.random.default_rng(3)
    vals = torch.as_tensor(rng.integers(0, V, (S, n)).astype(np.int32))
    active = torch.as_tensor(rng.random((S, n)) < 0.9)
    colmask = torch.as_tensor(rng.random((S, n)) < 0.8)
    side = (torch.as_tensor(rng.integers(0, 2, (S, n)).astype(np.int32))
            if with_side else None)
    p8 = torch.tensor([0, 1, 13, 64, 128, 255, 256], dtype=torch.int32)
    s0 = torch.as_tensor(rng.integers(0, 2**32, S, dtype=np.uint32)
                         .view(np.int32))
    s1r = torch.as_tensor(rng.integers(0, 2**32, S, dtype=np.uint32)
                          .view(np.int32))
    got = tfused.hist_exchange(vals, active, colmask, None, side, s0, s1r,
                               p8, V, mode="hw")
    want = torch.zeros((S, V, n))
    for s in range(S):
        words = [w & M32 for w in tfused.philox_bits(
            torch.stack([s0[s], s1r[s]]), ((n * n + 3) // 4,)).tolist()]
        for j in range(n):
            for i in range(n):
                idx = j * n + i
                draw = (words[idx >> 2] >> (8 * (idx & 3))) & 0xFF
                keep = p8[s] <= 0 or draw >= min(int(p8[s]), 255)
                link = (i != j and bool(colmask[s, i]) and keep
                        and int(p8[s]) < 256
                        and (side is None or side[s, i] == side[s, j]))
                if (link or i == j) and bool(active[s, i]):
                    want[s, vals[s, i], j] += 1
    assert torch.equal(got, want)


def _otr_runs(d, init, V, rounds, mode):
    tmix = interop.fault_mix_from_numpy(d, device="cpu")
    S, n = d["crashed"].shape
    rnd = tfast.OtrHist(V)
    init = torch.as_tensor(init)
    hist = tfast.run_hist(rnd, OtrState.fresh(init, S, n),
                          lambda s: s.decided, tmix, rounds, mode=mode)
    loop = tfast.run_otr_loop(rnd, OtrState.fresh(init, S, n), tmix, rounds,
                              mode=mode)
    return hist, loop


def test_run_hist_hw_equals_run_otr_loop_hw():
    """K1 derives salt1r per round and K2 receives it premixed: the two
    engines draw the same hw bits and agree bit for bit, as in hash mode;
    and hw mode draws other links than hash mode."""
    S, n, V = 12, 40, 6
    d = _np_mix(1, S, n, [0, 13, 64, 128, 200, 256], f=5, parts=True)
    init = np.random.default_rng(2).integers(0, V, n).astype(np.int32)
    hist, loop = _otr_runs(d, init, V, 8, "hw")
    for name in ("x", "decided", "decision", "after"):
        assert torch.equal(getattr(hist[0], name), getattr(loop[0], name))
    assert torch.equal(hist[1], loop[1]) and torch.equal(hist[2], loop[2])
    hash_loop = _otr_runs(d, init, V, 8, "hash")[1]
    assert not torch.equal(hash_loop[2], loop[2])


def test_hw_floodmin_and_benor_runs_complete():
    """The FloodMin and Ben-Or loops in hw mode equal the per-round engine
    in hw mode, decide, and keep their safety properties."""
    S, n = 10, 32
    d = _np_mix(4, S, n, [13, 64, 0, 26, 128], f=3)
    tmix = interop.fault_mix_from_numpy(d, device="cpu")
    init = torch.as_tensor(np.random.default_rng(6).integers(0, 40, n)
                           .astype(np.int32))
    rnd = tfast.FloodMinHist(40, 3)
    loop = tfast.run_floodmin_loop(rnd, FloodMinState.fresh(init, S, n),
                                   tmix, 6)
    hist = tfast.run_hist(rnd, FloodMinState.fresh(init, S, n),
                          lambda s: s.decided, tmix, 6, mode="hw")
    for name in ("x", "decided", "decision"):
        assert torch.equal(getattr(loop[0], name), getattr(hist[0], name))
    assert torch.equal(loop[2], hist[2])
    assert bool(loop[0].decided.all())
    assert bool(torch.isin(loop[0].decision, init).all())

    bits = init % 2 == 1
    bo = tfast.run_benor_loop(tfast.BenOrHist(), BenOrState.fresh(bits, S, n),
                              tmix, 16)
    bh = tfast.run_hist(tfast.BenOrHist(), BenOrState.fresh(bits, S, n),
                        lambda s: s.decided, tmix, 16, mode="hw")
    for name in ("x", "can_decide", "vote", "decided", "decision"):
        assert torch.equal(getattr(bo[0], name), getattr(bh[0], name))
    assert torch.equal(bo[2], bh[2])
    dec, decision = bo[0].decided, bo[0].decision
    assert bool(dec.any())
    for s in range(S):
        assert len(set(decision[s][dec[s]].tolist())) <= 1


def test_hw_statistics_against_round_tpu():
    """The port's hw run against round_tpu's hash run (interpret mode) on
    one numpy-made mix: n=64, S=256, p8=64, 10 rounds.  The two runs share
    mix and initial values and differ in their link streams only.  Scenarios
    are the independent units, so the decided fractions may differ by 4
    standard deviations of the difference of two binomial fractions over S
    scenarios (the variance floored at 1/S); the p50 decided round by one
    round."""
    S, n, V, rounds = 256, 64, 8, 10
    d = _np_mix(0, S, n, 64)
    init = np.random.default_rng(10).integers(0, V, n).astype(np.int32)
    x0 = jnp.broadcast_to(jnp.asarray(init), (S, n))
    want = jfused.otr_loop(x0, *[jnp.asarray(d[k]) for k in LOOP_ARGS],
                           num_values=V, rounds=rounds, mode="hash",
                           interpret=True)
    jcnt, jhist = jbenchstat.decided_summary(want[1], want[5], rounds)
    got = _otr_runs(d, init, V, rounds, "hw")[1]
    tcnt, thist = tbenchstat.decided_summary(got[0].decided, got[2], rounds)
    f_ref = int(jcnt) / (S * n)
    f_hw = int(tcnt) / (S * n)
    tol = 4 * math.sqrt(2 * max(f_ref * (1 - f_ref), 1 / S) / S)
    assert 0.5 < f_ref and abs(f_hw - f_ref) <= tol, (f_hw, f_ref, tol)
    p50_ref = jbenchstat.p50_from_hist(np.asarray(jhist))
    p50_hw = tbenchstat.p50_from_hist(thist)
    assert p50_ref >= 0 and abs(p50_hw - p50_ref) <= 1


def test_ladder_times_hw_on_the_card_only():
    """The ladder's timed runs draw hw links on the card and hash links on
    the CPU, as round_tpu's ladder does (hash when interpreting)."""
    assert ladder._timed_mode(torch.device("cpu")) == "hash"
    assert ladder._timed_mode(torch.device("cuda")) == "hw"
