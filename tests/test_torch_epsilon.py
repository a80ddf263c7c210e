"""Port parity: ε-agreement (ops/detsum, models/epsilon, engine/epsfast,
the ladder's fifth rung and the dry run's ε segment).

``tree_sum`` and both ε engines run on the same inputs as round_tpu: the
reference draws its initial values and HO masks (byzantine silence,
omission, crash) from its keys, the masks replay in the port through
``from_schedule``, and every state leaf is compared as raw bits (NaN
decisions of undecided lanes included), with ``decided_round`` and
``done`` (tolerance 0).  The horizon ⌈log(diff/ε)/log c⌉ is held against
the reference's model code over random spreads and at spreads of exactly
ε·c^k, where the ceiling would flip on a last-place difference of the two
packages' float32 logs (``test_horizon_exact_spreads``); the port's log is
XLA's CPU log, emulated (``test_horizon_log_*``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.core.rounds import RoundCtx as JRoundCtx
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.models.epsilon import EpsilonConsensus as JEps
from round_tpu.ops import detsum as jdetsum
from round_tpu.ops.mailbox import Mailbox as JMailbox
from round_tpu.spec import replay_ho as jreplay_ho
from round_tpu_torch.apps import ladder
from round_tpu_torch.core.rounds import RoundCtx as TRoundCtx
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.engine.epsfast import run_epsilon_batch, run_epsilon_fast
from round_tpu_torch.engine.executor import run_instance as trun_instance
from round_tpu_torch.models.epsilon import EpsilonConsensus as TEps
from round_tpu_torch.models.epsilon import real_consensus_io
from round_tpu_torch.ops import detsum as tdetsum
from round_tpu_torch.ops.mailbox import Mailbox as TMailbox
from round_tpu_torch.parallel import mesh as tmesh

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ("x", "max_r", "halted_vals", "halted_mask", "decided", "decision")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != bool else a


@pytest.mark.parametrize("m", [0, 1, 3, 8, 32])
def test_tree_sum_matches_jax(m):
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((5, m)) * 10.0 ** rng.integers(-3, 4, (5, m))
         ).astype(np.float32)
    if m:
        x[0, 0] = -0.0  # the sign of zero survives or not alike
    want = np.asarray(jdetsum.tree_sum(jnp.asarray(x), axis=-1))
    got = tdetsum.tree_sum(torch.from_numpy(x), dim=-1).numpy()
    assert (_bits(got) == _bits(want)).all()
    # the other axis, and through vmap over rows
    want0 = np.asarray(jdetsum.tree_sum(jnp.asarray(x.T), axis=0))
    got0 = tdetsum.tree_sum(torch.from_numpy(x.T.copy()), dim=0).numpy()
    assert (_bits(got0) == _bits(want0)).all()
    gotv = torch.func.vmap(tdetsum.tree_sum)(torch.from_numpy(x)).numpy()
    assert (_bits(gotv) == _bits(want)).all()
    with tdetsum.extracting():
        assert torch.equal(tdetsum.tree_sum(torch.ones(3, m), dim=1),
                           torch.full((3,), float(m)))
    assert not tdetsum._EXTRACTING.get()


# -- the engines on the reference's masks and inputs ------------------------

CASES = [("silence", 16, 2, 17), ("omission", 16, 2, 41), ("crash", 16, 2, 73),
         ("silence", 32, 3, 5), ("omission", 32, 3, 9), ("crash", 32, 3, 11)]


def _jsampler(fam, n, f):
    return {"silence": jscen.byzantine_silence(n, f),
            "omission": jscen.omission(n, 0.2),
            "crash": jscen.crash(n, f)}[fam]


@pytest.fixture(scope="module")
def reference_runs():
    """(fam, n, f, seed) -> (eps, phases, init, ho, reference RunResult)
    for the reference's first scenario of that seed, as its epsfast tests
    draw it."""
    out = {}
    for fam, n, f, seed in CASES:
        eps, phases = (0.5, 8) if n == 16 else (0.25, 12)
        sampler = _jsampler(fam, n, f)
        k_io, k_run = jax.random.split(jax.random.split(
            jax.random.PRNGKey(seed), 3)[0])
        init = jax.random.uniform(k_io, (n,), jnp.float32) * 100.0
        res = jrun_instance(JEps(n, f=f, epsilon=eps),
                            {"initial_value": init}, n, k_run, sampler,
                            max_phases=phases)
        ho = np.asarray(jreplay_ho(k_run, sampler, phases))
        out[(fam, n, f, seed)] = (eps, phases, np.asarray(init), ho, res)
    return out


def _assert_bit_equal(got, want):
    for name in FIELDS:
        a = _bits(getattr(got.state, name).cpu().numpy())
        b = _bits(getattr(want.state, name))
        assert a.shape == b.shape and (a == b).all(), name
    np.testing.assert_array_equal(got.decided_round.cpu().numpy(),
                                  np.asarray(want.decided_round))
    np.testing.assert_array_equal(got.done.cpu().numpy(),
                                  np.asarray(want.done))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1]}")
def test_engines_match_jax(case, reference_runs):
    fam, n, f, _seed = case
    eps, phases, init, ho, want = reference_runs[case]
    ho, init = ho.copy(), init.copy()
    algo = TEps(n, f=f, epsilon=eps)
    sched = tscen.from_schedule(torch.from_numpy(ho))
    io = real_consensus_io(torch.from_numpy(init))
    gen = trun_instance(algo, io, n, (0, 0), sched, phases, device=CPU)
    _assert_bit_equal(gen, want)
    fast = run_epsilon_fast(algo, io, n, (0, 0), sched, phases, device=CPU)
    _assert_bit_equal(fast, want)
    # non-vacuity: something decided and something halted
    assert bool(gen.state.decided.any())
    assert bool(gen.state.halted_mask.any())


def test_fast_batch_matches_general_engine():
    """The port's batched count-rank engine against its general engine on
    the port's own samplers, scenario by scenario."""
    n, f, S = 32, 3, 4
    algo = TEps(n, f=f, epsilon=0.25)
    gen = torch.Generator().manual_seed(3)
    x0 = torch.rand((S, n), generator=gen) * 100.0
    keys = [(11 * s + 1, 5) for s in range(S)]
    for sampler in (tscen.byzantine_silence(n, f, device=CPU),
                    tscen.quorum_omission(n, 0.3, lambda n: n // 2 + 1,
                                          device=CPU),
                    tscen.crash_at(n, f, 2, device=CPU)):
        fast = run_epsilon_batch(algo, x0, keys, sampler, 10)
        for s in range(S):
            ref = trun_instance(algo, real_consensus_io(x0[s]), n, keys[s],
                                sampler, 10, device=CPU)
            for name in FIELDS:
                a, b = getattr(fast.state, name)[s], getattr(ref.state, name)
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), name
            assert torch.equal(fast.done[s], ref.done)
            assert torch.equal(fast.decided_round[s], ref.decided_round)


# -- the horizon --------------------------------------------------------------

def _horizons(n, f, eps, spreads):
    """max_r after round 0 for a mailbox holding {0, spread, ...} in both
    packages' EpsilonRound.update (the reference's own code)."""
    sp = np.asarray(spreads, np.float32)
    vals = np.zeros((len(sp), n), np.float32)
    vals[:, 1] = sp
    jrnd = JEps(n, f=f, epsilon=eps).rounds[0]
    talgo = TEps(n, f=f, epsilon=eps)
    trnd = talgo.rounds[0]

    def jone(v):
        ctx = JRoundCtx(id=jnp.int32(0), n=n, r=jnp.int32(0))
        st = JEps(n, f=f, epsilon=eps).make_init_state(
            ctx, {"initial_value": v[0]})
        mbox = JMailbox({"v": v, "halt": jnp.zeros(n, bool)},
                        jnp.ones(n, bool))
        return jrnd.update(ctx, st, mbox).max_r

    want = np.asarray(jax.jit(jax.vmap(jone))(jnp.asarray(vals)))

    def tone(v):
        ctx = TRoundCtx(id=torch.tensor(0, dtype=torch.int32), n=n,
                        r=torch.tensor(0, dtype=torch.int32))
        st = talgo.make_init_state(ctx, {"initial_value": v[0]})
        mbox = TMailbox({"v": v, "halt": torch.zeros(n, dtype=torch.bool)},
                        torch.ones(n, dtype=torch.bool))
        return trnd.update(ctx, st, mbox).max_r

    got = torch.func.vmap(tone)(torch.from_numpy(vals)).numpy()
    return got, want


# (n, f) -> c: 16, 2 -> 3; 32, 3 -> 4 (as the rung's 1024, 100); 16, 1 -> 7
SHAPES = [(16, 2), (32, 3), (16, 1)]


@pytest.mark.parametrize("eps", [0.5, 0.1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}f{s[1]}")
def test_horizon_random_spreads(shape, eps):
    n, f = shape
    c = TEps(n, f=f, epsilon=eps).rounds[0].c
    rng = np.random.default_rng(n * 10 + f)
    sp = np.concatenate([rng.random(3000) * 200.0,
                         10.0 ** rng.uniform(-4, 6, 3000)]).astype(np.float32)
    # spreads of exactly ε·c^k are test_horizon_exact_spreads' cases
    ratio = sp.astype(np.float64) / np.float64(np.float32(eps))
    k = np.round(np.log(ratio) / math.log(c))
    sp = sp[~np.isclose(ratio, float(c) ** k, rtol=1e-6, atol=0)]
    got, want = _horizons(n, f, eps, sp)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("eps", [0.5, 0.1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}f{s[1]}")
def test_horizon_exact_spreads(shape, eps):
    """Spreads of exactly ε·c^k (float32) and their float32 neighbours,
    where log(diff/ε)/log(c) lands on or next to an integer: the horizons
    equal round_tpu's, c a power of two (the rung's c = 4) or not (3, 7).
    The port's horizon_log is XLA's float32 CPU log bit for bit, and log(c)
    the correctly rounded constant XLA folds."""
    n, f = shape
    c = TEps(n, f=f, epsilon=eps).rounds[0].c
    e32 = np.float32(eps)
    exact = np.array([e32 * np.float32(c) ** k for k in range(1, 26)],
                     np.float32)
    exact = exact[np.isfinite(exact) & (exact < 3e38)]
    sp = np.concatenate([exact, np.nextafter(exact, np.float32(np.inf)),
                         np.nextafter(exact, np.float32(0))])
    got, want = _horizons(n, f, eps, sp)
    np.testing.assert_array_equal(got, want)


def _xla_log_matches(bits: np.ndarray) -> np.ndarray:
    """Where the port's horizon_log gives jnp.log's bits (NaN for NaN)."""
    from round_tpu_torch.models.epsilon import horizon_log

    x = bits.view(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    got = horizon_log(torch.from_numpy(x.copy())).numpy()
    return ((got.view(np.uint32) == want.view(np.uint32))
            | (np.isnan(got) & np.isnan(want)))


def test_horizon_log_is_xla_log_on_a_sample():
    """2^20 float32 bit patterns drawn over the whole range (negative,
    subnormal, NaN and infinite ones among them) and the edge values: the
    port's emulation of XLA's CPU log gives jnp.log's bits on every one."""
    rng = np.random.default_rng(9)
    bits = np.concatenate([
        rng.integers(0, 2**32, 2**19, dtype=np.uint64).astype(np.uint32),
        rng.integers(0x00800000, 0x7F800000, 2**19, dtype=np.uint32),
        np.array([0, 1, 0x007FFFFF, 0x00800000, 0x00800001, 0x3F3504F2,
                  0x3F3504F3, 0x3F3504F4, 0x3F800000, 0x3F7FFFFF,
                  0x7F7FFFFF, 0x7F800000, 0x7FC00000, 0x80000000,
                  0x80000001, 0xBF800000, 0xFF800000], dtype=np.uint32)])
    ok = _xla_log_matches(bits)
    assert ok.all(), bits[~ok][:10]


@pytest.mark.slow
def test_horizon_log_full_sweep():
    """Every positive float32 (subnormal, normal, +inf: 2^31 − 2^23 bit
    patterns, in chunks of 2^24): the port's horizon_log against jnp.log,
    bit for bit.  ~10 minutes on 8 CPU threads: run it with
    ``pytest tests/test_torch_epsilon.py -m slow -k full_sweep -s``."""
    chunk, top, bad = 1 << 24, 0x7F800001, 0
    for lo in range(1, top, chunk):
        bits = np.arange(lo, min(lo + chunk, top), dtype=np.uint32)
        bad += int((~_xla_log_matches(bits)).sum())
    print(f"horizon_log vs jnp.log: {bad} of {top - 1} positive float32 "
          "differ")
    assert bad == 0


# -- the fifth rung and the dry run's ε segment, small, on the CPU ----------

def test_rung_epsilon_on_cpu():
    res = ladder.rung_epsilon(repeats=1, n=16, S=4, parity_k=2, device=CPU)
    assert res["metric"] == "ladder_epsilon_n16"
    ex = res["extra"]
    assert ex["parity_exact"] is True and ex["parity_frac"] == 1.0
    assert ex["property_parity"] is True
    assert ex["sharded"] is False and ex["engine"] == "eps_fused"
    assert ex["f"] == 1 and ex["eps"] == 0.5
    assert ex["rounds_per_sec"] > 0 and ex["frac_lanes_decided"] > 0


def test_dryrun_eps_segment_on_cpu(capsys):
    tmesh.dryrun_eps(2, devices=[CPU, CPU])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("dryrun_multichip eps-fused ok")
