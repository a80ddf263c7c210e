"""Port parity: the config ladder (round_tpu_torch.apps.ladder).

The timed computation of the floodmin, lv and benor rungs (mix -> engine
-> decided_summary) gives the same (count, decided-round histogram,
decision checksum) in both packages on the same numpy-made mix and
initial values.  Each port rung, run small on the CPU, returns parity 1.0
and true invariant/property parities under round_tpu's metric name and
``extra`` keys."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.models.benor import BenOrState as JBenOrState
from round_tpu.models.floodmin import FloodMinState as JFloodMinState
from round_tpu.ops import fused as jfused
from round_tpu.utils import benchstat as jbenchstat
from round_tpu_torch import interop
from round_tpu_torch.apps import ladder

REPO = Path(__file__).resolve().parent.parent
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
LOOP_ARGS = ("crashed", "side", "crash_round", "heal_round", "rotate_down",
             "p8", "salt0", "salt1")
SPEED = {"rounds_per_sec", "wall_s_per_run", "rounds_per_run",
         "frac_lanes_decided"}
# round_tpu/apps/ladder.py: the metric name and the extra keys of each
# rung (speed_extra plus the extra.update of :138, :318-321, :425-430 and
# :528-532; the otr4 loop keys of :181-182)
REFERENCE = {
    "otr4": ("ladder_otr_n4", SPEED | {
        "decided_phase_p50", "invariant_parity", "property_parity",
        "loop_rounds_per_sec", "loop_parity_frac"}),
    "floodmin": ("ladder_floodmin_n{n}", SPEED | {
        "decided_round_p50", "f", "engine", "parity_frac",
        "property_parity"}),
    "lv": ("ladder_lv_n{n}", SPEED | {
        "decided_round_p50", "f", "engine", "parity_frac",
        "invariant_parity", "property_parity"}),
    "benor": ("ladder_benor_n{n}", SPEED | {
        "decided_round_p50", "engine", "parity_frac", "agreement_parity",
        "invariant_parity", "property_parity"}),
}


def _np_mix(seed, S, n, f=0, p8=0):
    """A FaultMix as numpy arrays: f crashed lanes per scenario from round
    0 (a uniform permutation each) and a uniform drop threshold p8."""
    rng = np.random.default_rng(seed)
    crashed = np.argsort(rng.random((S, n)), axis=1) < f
    z = np.zeros((S,), np.int32)
    return {
        "crashed": crashed, "crash_round": z,
        "side": np.zeros((S, n), np.int32), "heal_round": z,
        "rotate_down": z, "p8": np.full((S,), p8, np.int32),
        "salt0": rng.integers(0, 2**32, S, dtype=np.uint32).view(np.int32),
        "salt1": rng.integers(0, 2**32, S, dtype=np.uint32).view(np.int32),
    }


def _both(d):
    jmix = jfast.FaultMix(**{k: jnp.asarray(d[k]) for k in MIX_FIELDS})
    return jmix, interop.fault_mix_from_numpy(d, device="cpu")


def _assert_summary(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_floodmin_body_matches_jax(seed):
    S, n, f, V, rounds = 6, 12, 2, 1000, 4
    jmix, tmix = _both(_np_mix(seed, S, n, f=f))
    init = np.random.default_rng(seed + 50).integers(0, V, n).astype(np.int32)
    st0 = JFloodMinState(x=jnp.broadcast_to(init, (S, n)),
                         decided=jnp.zeros((S, n), bool),
                         decision=jnp.full((S, n), -1, jnp.int32))
    state, _done, dround = jfast.run_floodmin_loop(
        jfast.FloodMinHist(V, f), st0, jmix, rounds, mode="hash",
        interpret=True)
    want = jbenchstat.decided_summary(state.decided, dround, rounds,
                                      state.decision)
    got = ladder.floodmin_body(tmix, torch.as_tensor(init), f, V, rounds,
                               mode="hash")[0]
    _assert_summary(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_lv_body_matches_jax(seed):
    S, n, rounds = 6, 12, 16
    jmix, tmix = _both(_np_mix(seed, S, n, f=2))
    init = np.random.default_rng(seed + 60).integers(0, 64, n).astype(np.int32)
    x0 = jnp.broadcast_to(init, (S, n))
    out = jfused.lv_loop(x0, *[getattr(jmix, k) for k in LOOP_ARGS],
                         rounds=rounds, interpret=True)
    want = jbenchstat.decided_summary(out[5], out[8], rounds, out[6])
    got = ladder.lv_body(tmix, torch.as_tensor(init), rounds)[0]
    _assert_summary(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_benor_body_matches_jax(seed):
    S, n, rounds = 6, 12, 16
    jmix, tmix = _both(_np_mix(seed, S, n, p8=13))
    init = np.random.default_rng(seed + 70).random(n) < 0.5
    st0 = JBenOrState(x=jnp.broadcast_to(init, (S, n)),
                      can_decide=jnp.zeros((S, n), bool),
                      vote=jnp.full((S, n), -1, jnp.int32),
                      decided=jnp.zeros((S, n), bool),
                      decision=jnp.zeros((S, n), bool))
    state, _done, dround = jfast.run_benor_loop(
        jfast.BenOrHist(), st0, jmix, rounds, mode="hash", interpret=True)
    want = jbenchstat.decided_summary(state.decided, dround, rounds,
                                      state.decision.astype(jnp.int32))
    got = ladder.benor_body(tmix, torch.as_tensor(init), rounds,
                            mode="hash")[0]
    _assert_summary(got, want)


@pytest.mark.parametrize("name", ["otr4", "floodmin", "lv", "benor"])
def test_rung_on_cpu(name):
    n, S = 12, 8
    kw = {} if name == "otr4" else {"n": n, "S": S}
    res = ladder.RUNGS[name](repeats=1, device="cpu", **kw)
    metric, keys = REFERENCE[name]
    assert res["metric"] == metric.format(n=n)
    extra = res["extra"]
    assert set(extra) == keys
    assert extra["rounds_per_sec"] > 0
    assert extra.get("parity_frac", extra.get("loop_parity_frac")) == 1.0
    for k, v in extra.items():
        if k.endswith("_parity"):
            assert v is True, k


def test_ladder_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "round_tpu_torch.apps.ladder", "--device",
         "cpu", "--only", "floodmin,lv", "--n", "8", "--scenarios", "4",
         "--repeats", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert [r["metric"] for r in lines] == ["ladder_floodmin_n8",
                                            "ladder_lv_n8"]
    assert all(r["extra"]["backend"] == "cpu" for r in lines)
    with pytest.raises(ValueError, match="unknown rungs"):
        ladder.run_ladder(["epsilon"], device="cpu")
