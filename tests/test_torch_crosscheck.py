"""The proof/fuzzer cross-check (round_tpu_torch/byz/crosscheck.py) and
the hostile-wire gate (round_tpu_torch/fuzz/hostile.py) against
round_tpu's, on the CPU: the numpy-drawn parts of ``liar_rows``, the
``early_victim_split`` predicate and the envelope budgets are
round_tpu's; the port's cross-check holds its claims at the acceptance
scale (10,000 in-envelope schedules) and agrees with round_tpu's
verdicts on a small one; and the hostile gate accounts for every frame,
frame for frame as round_tpu's does."""

import numpy as np
import pytest
import torch

import round_tpu.apps.selector as r_sel
import round_tpu.byz.crosscheck as r_cc
import round_tpu.fuzz.hostile as r_hostile
from round_tpu.fuzz import replay as r_replay
from round_tpu_torch.apps.selector import select
from round_tpu_torch.byz import crosscheck as p_cc
from round_tpu_torch.fuzz import genome
from round_tpu_torch.fuzz import hostile as p_hostile
from round_tpu_torch.fuzz import replay

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)


@pytest.mark.parametrize("n,liars,seed", [(4, 1, 0), (4, 2, 3), (7, 2, 9)])
def test_liar_rows_equal_round_tpus_where_numpy_draws(n, liars, seed):
    """The liar set, the equivocation intensity and the stale share come
    from numpy's generator in both packages; the fault families come
    from each package's seed population (a listed divergence), so only
    their fields and shapes are compared."""
    got = p_cc.liar_rows(n, 12, liars, seed=seed)
    want = r_cc.liar_rows(n, 12, liars, seed=seed)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert set(g) == set(genome._FIELDS) == set(w)
        for f in ("byz_value", "equiv_p8", "stale_p8"):
            assert np.array_equal(np.asarray(g[f]), np.asarray(w[f])), f
        for f in genome._FIELDS:
            assert np.shape(g[f]) == np.shape(w[f]), f
        assert int(np.asarray(g["byz_value"]).sum()) == min(liars, n)


def test_early_victim_split_equals_round_tpus():
    rng = np.random.default_rng(1)
    P, n = 256, 4
    out = {"decided": rng.random((P, n)) < 0.9,
           "decision": rng.integers(0, 2, (P, n)),
           "decided_round": rng.integers(0, 6, (P, n))}
    got = p_cc.early_victim_split()(out)
    want = r_cc.early_victim_split()(out)
    assert np.array_equal(got, want) and got.any()


@pytest.mark.parametrize("name", ["otr", "lastvoting", "pbft", "pbft-vc"])
def test_adversary_budget_equals_round_tpus(name):
    for n in range(1, 11):
        assert p_cc.adversary_budget(select(name), n) == \
            r_cc.adversary_budget(r_sel.select(name), n)


@pytest.mark.parametrize("proto", ["otr", "lastvoting", "pbft"])
def test_crosscheck_envelopes(proto, tmp_path):
    """The port at the acceptance scale of round_tpu's slow-marked
    cross-check: >= 10k in-envelope schedules with no safety violation;
    past the envelope the benign protocols yield a banked, minimized
    equivocation counterexample that replays on both packages' engines
    to the same outcome, and PBFT yields none.  round_tpu's cross-check
    on a small budget gives the same in-envelope and PBFT verdicts."""
    res = p_cc.crosscheck(proto, 4, min_schedules=10_000, seed=3,
                          bank_dir=str(tmp_path), device="cpu")
    assert res.in_ok and res.inside.evaluated >= 10_000, res.record()
    assert res.past_ok, res.record()
    if proto in ("otr", "lastvoting"):
        assert res.past.violation and res.artifact is not None
        assert res.artifact["value_subs"] or res.artifact["stale_subs"]
        art = replay.load_artifact(res.artifact_path)
        ok, got = replay.check_engine(art, device="cpu")
        assert ok, got
        assert r_replay.check_engine(
            r_replay.load_artifact(res.artifact_path)) == (True, got)
    else:
        assert not res.past.violation
    ref = r_cc.crosscheck(proto, 4, min_schedules=256, pop_size=256)
    small = p_cc.crosscheck(proto, 4, min_schedules=256, pop_size=256,
                            device="cpu")
    assert ref.in_ok and small.in_ok
    assert not ref.inside.violation and not small.inside.violation
    if proto == "pbft":
        assert not ref.past.violation and not small.past.violation


def test_hostile_gate_accounts_every_frame_as_round_tpus():
    """``run_gate`` on the port's codec, splitter and native pump: every
    frame consumed or rejected, no gadget fired; the codec and splitter
    surfaces take the same seeded frames as round_tpu's and consume and
    reject the same ones, operator by operator."""
    out = p_hostile.run_gate(3000, seed=0)
    assert out["ok"], {k: v for k, v in out.items() if k != "codec"}
    for name in ("fuzz_codec", "fuzz_split"):
        got = getattr(p_hostile, name)(500, 4)
        want = getattr(r_hostile, name)(500, 4)
        assert got["ok"] and want["ok"]
        assert got["by_op"] == want["by_op"], name
        assert (got["consumed"], got["rejected"]) == \
            (want["consumed"], want["rejected"])
    assert p_hostile.GADGET_FIRED["count"] == 0
