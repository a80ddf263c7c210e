"""Spec-derived lane objectives: how much a fault schedule hurt.

Port of round_tpu/fuzz/objectives.py.  Every score is computed on the
device over the whole [P]-candidate batch, in the same program as the
engine run (fuzz/search.py), from the reference's Spec properties
(Specs.scala:9-19) reduced to per-candidate scalars:

  undecided        — Termination's failure mass: fraction of processes
                     undecided at the horizon;
  decide_round     — the LAST process's decision round (horizon where
                     undecided);
  agreement_viol   — # unordered pairs of decided processes with
                     differing decisions (>0 = safety bug);
  validity_viol    — # decided processes whose decision is no process's
                     initial value (>0 = safety bug).

Arbitrary spec/dsl.py formulas plug in through ``spec_holds``.

The floats follow round_tpu's compiled program bit for bit: XLA on the CPU
turns the division of ``jnp.mean`` and of ``/ horizon`` into a product
with the float32 reciprocal, and contracts ``1 - s·(1/n)`` and
``undecided + decide_round·(1/h)`` into fused multiply-adds, each rounded
once to float32.  Here both are computed exactly in float64 (the products
of small integers and a float32 reciprocal are exact there) and rounded
once; the two remaining terms (``100·viol``, ``0.25·severity``) are exact
products added in float32.  The search sorts on these scores, so one ulp
would change which genomes survive.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.func import vmap

from round_tpu_torch.spec.dsl import Env

# weight of a safety violation in the combined score: any schedule that
# breaks agreement/validity dominates every schedule that merely degrades
# liveness
SAFETY_WEIGHT = 100.0


def _recip32(k: int) -> float:
    """float32 reciprocal of ``k`` as a Python float (exact in float64)."""
    return float(np.float32(1.0) / np.float32(k))


def lane_objectives(decided: torch.Tensor, decision: torch.Tensor,
                    decided_round: torch.Tensor, init_values: torch.Tensor,
                    horizon: int,
                    honest: torch.Tensor = None,
                    null_value=None,
                    extra_valid: torch.Tensor = None
                    ) -> Dict[str, torch.Tensor]:
    """Per-candidate objective components from a batched engine outcome
    (round_tpu/fuzz/objectives.py::lane_objectives).

    decided [P, n] bool, decision [P, n], decided_round [P, n] int32 (-1 =
    never), init_values [n] (Validity's witness set), horizon = rounds
    simulated.  Returns a dict of [P] tensors.  ``honest`` ([P, n] bool)
    scopes the safety terms to non-byzantine lanes; ``null_value`` marks
    an explicit null decision, which leaves the safety terms but counts as
    decided; ``extra_valid`` ([P, n] bool) widens Validity's witness set
    to values an active liar claimed."""
    n = decided.shape[1]
    s = decided.to(torch.float64).sum(dim=1)
    und = (1.0 - s * _recip32(n)).to(torch.float32)
    dr = torch.where(decided_round < 0, horizon, decided_round)
    decide_round = dr.max(dim=1).values.to(torch.int32)

    hdec = decided if honest is None else decided & torch.as_tensor(honest)
    if null_value is not None:
        hdec = hdec & (decision != null_value)
    both = hdec[:, :, None] & hdec[:, None, :]
    diff = decision[:, :, None] != decision[:, None, :]
    agreement_viol = ((both & diff).to(torch.int32).sum(dim=(1, 2))
                      // 2).to(torch.int32)

    init_values = torch.as_tensor(init_values, device=decision.device)
    valid = (decision[:, :, None] == init_values[None, None, :]).any(dim=2)
    if extra_valid is not None:
        valid = valid | torch.as_tensor(extra_valid)
    validity_viol = (hdec & ~valid).to(torch.int32).sum(dim=1).to(
        torch.int32)

    return {
        "undecided": und,
        "decide_round": decide_round,
        "agreement_viol": agreement_viol,
        "validity_viol": validity_viol,
    }


def combined_score(obj: Dict[str, torch.Tensor], severity: torch.Tensor,
                   horizon: int,
                   severity_weight: float = 0.25) -> torch.Tensor:
    """The scalar the search maximizes: liveness damage (undecided mass +
    normalized decision delay) + safety violations at SAFETY_WEIGHT, minus
    a small severity rent (round_tpu/fuzz/objectives.py::combined_score),
    float32 as round_tpu's compiled program rounds it (module docstring)."""
    und = obj["undecided"]
    viol = (obj["agreement_viol"] + obj["validity_viol"]) > 0
    live = (und.to(torch.float64)
            + obj["decide_round"].to(torch.float64)
            * _recip32(max(1, horizon))).to(torch.float32)
    sev = torch.as_tensor(severity, device=und.device).to(torch.float32)
    return ((live + SAFETY_WEIGHT * viol.to(torch.float32))
            - severity_weight * sev)


def kv_stream_viol(decided: torch.Tensor, decision: torch.Tensor,
                   record_value) -> torch.Tensor:
    """[P] int32: the KV decision-stream invariant as a lane objective
    (round_tpu/fuzz/objectives.py::kv_stream_viol): every decided lane
    whose decision differs from the uniformly-proposed client record is a
    phantom apply."""
    bad = decided & (decision != record_value)
    return bad.to(torch.int32).sum(dim=1).to(torch.int32)


def spec_holds(formula: Callable[[Env], Any], state: Any, n: int
               ) -> torch.Tensor:
    """[P] bool: one spec/dsl.py formula on every candidate's final state,
    batched over the population axis with ``torch.func.vmap``
    (round_tpu/fuzz/objectives.py::spec_holds)."""
    return vmap(lambda st: torch.as_tensor(formula(Env(state=st, n=n))))(
        state)


# ---------------------------------------------------------------------------
# Minimizer predicates (host-side, over numpy outcome dicts)
# ---------------------------------------------------------------------------
#
# A predicate maps the batched outcome of candidate schedules to a [K] bool
# "does this candidate still reproduce the finding", fuzz/minimize.py's
# oracle, over the numpy outcome dict fuzz/search.FuzzTarget returns.


def undecided_at_horizon(min_lanes: int = 1):
    """>= min_lanes processes still undecided when the horizon hits
    (round_tpu/fuzz/objectives.py::undecided_at_horizon)."""

    def pred(out):
        return (~np.asarray(out["decided"])).sum(axis=1) >= min_lanes

    pred.__name__ = f"undecided_at_horizon(min_lanes={min_lanes})"
    return pred


def decision_delayed(min_round: int):
    """The last decider's round >= min_round, undecided counting as the
    horizon (round_tpu/fuzz/objectives.py::decision_delayed)."""

    def pred(out):
        return np.asarray(out["decide_round"]) >= min_round

    pred.__name__ = f"decision_delayed(min_round={min_round})"
    return pred


def safety_violated():
    """Agreement or validity broken (round_tpu/fuzz/objectives.py::
    safety_violated)."""

    def pred(out):
        return (np.asarray(out["agreement_viol"])
                + np.asarray(out["validity_viol"])) > 0

    pred.__name__ = "safety_violated()"
    return pred


def kv_stream_violated(record_value: int):
    """``kv_stream_viol`` as a minimizer predicate: some decided lane
    applied a record that is not the uniformly-proposed client record
    (round_tpu/fuzz/objectives.py::kv_stream_violated)."""

    def pred(out):
        bad = (np.asarray(out["decided"])
               & (np.asarray(out["decision"]) != record_value))
        return bad.sum(axis=1) > 0

    pred.__name__ = f"kv_stream_violated(record={record_value})"
    return pred
