"""Shared IO conventions for the algorithm library.

Port of round_tpu/models/common.py: the io is a pytree of per-lane inputs
and decisions are fields of the state (Algorithm.decided/decision)."""

from __future__ import annotations

import torch


def consensus_io(initial_values, device=None) -> dict:
    """io pytree for consensus algorithms: one initial value per process."""
    return {"initial_value": torch.as_tensor(initial_values, device=device)}


def ghost_decide(state, deciding, value):
    """Fold a decision event into the ghost ``decided``/``decision`` fields:
    a lane's ``decision`` is written exactly once, on the round where
    ``deciding`` first becomes true (Otr.scala:74-78, BenOr.scala:41-44)."""
    newly = deciding & ~state.decided
    return state.replace(
        decided=state.decided | deciding,
        decision=torch.where(newly, value, state.decision),
    )
