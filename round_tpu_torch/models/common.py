"""Shared IO conventions for the algorithm library.

Port of round_tpu/models/common.py: the io is a pytree of per-lane inputs
and decisions are fields of the state (Algorithm.decided/decision).  The
consensus properties that the OTR, LastVoting and Ben-Or specs state alike
(Otr.scala:108-120, LastVoting.scala:58-70) are written here once."""

from __future__ import annotations

import torch

from round_tpu_torch.spec.dsl import implies


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


def agreement(e):
    """Decided processes decide the same value."""
    return e.P.forall(lambda i: e.P.forall(lambda j: implies(
        i.decided & j.decided, i.decision == j.decision)))


def validity(e):
    """A decision is some process's initial value."""
    return e.P.forall(lambda i: implies(
        i.decided, e.P.exists(lambda j: j.init.x == i.decision)))


def integrity(e):
    """All decisions are one process's initial value."""
    return e.P.exists(lambda j: e.P.forall(
        lambda i: implies(i.decided, i.decision == j.init.x)))


def irrevocability(e):
    """A decision, once made, stays."""
    return e.P.forall(lambda i: implies(
        i.old.decided, i.decided & (i.old.decision == i.decision)))


def termination(e):
    """Every process has decided (checked at the end of a run)."""
    return e.P.forall(lambda i: i.decided)
