"""Trace checking: evaluate a Spec over recorded execution traces.

Port of round_tpu/spec/check.py.  Instead of discharging VCs to an SMT
solver (Verifier.scala:234-276), the simulator records every round's state
and the checker evaluates the spec formulas exactly on each step.  The
BASELINE "invariant parity" metric is this module agreeing with the JVM
semantics.

Conventions:
  - a trace is the pytree of states stacked over rounds: leaves [T, n, ...]
    (produced by running the engine with ``record_fn=lambda s, d, r: s``);
  - ``old`` at step t is the state at t-1 (the init state at t=0);
  - the HO matrix per step is replayed from the scenario key (the engine's
    samplers are deterministic functions of (key, r): replay_ho).

round_tpu evaluates the steps under one ``jax.vmap`` inside ``jax.jit``;
here the steps are a Python loop (the quantifiers inside a step are
vmapped), which keeps the intermediate tensors one step large.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from round_tpu_torch.spec.dsl import Env, Spec, SpecFieldError
from round_tpu_torch.utils.tree import tree_leaves, tree_map

# The decision-plane property slots a single replica can check exactly
# over its own observations (round_tpu/spec/check.py::WIRE_MONITORS).
WIRE_MONITORS = ("agreement", "validity", "irrevocability")
# property names that are liveness claims: meaningful only at the end of a
# run, never on a mid-run state
_LIVENESS_NAMES = frozenset({"termination"})


def formula_scope(kind: str, name: str) -> str:
    """The live/offline/final classification of a formula
    (round_tpu/spec/check.py::formula_scope):

      live    — decision-plane properties with an exact locally-checkable
                per-replica form (WIRE_MONITORS);
      final   — liveness properties, meaningful only at the end of a run;
      offline — full-state formulas (invariants, safety_predicate,
                round_invariants, remaining safety properties).
    """
    if kind == "property":
        low = name.lower()
        if low in WIRE_MONITORS:
            return "live"
        if low in _LIVENESS_NAMES:
            return "final"
    return "offline"


def formula_label(f, fallback: str) -> str:
    """Human-readable name for a spec formula: plain methods/functions use
    their qualname; lambdas fall back to the structural position
    (round_tpu/spec/check.py::formula_label)."""
    name = getattr(f, "__qualname__", "") or getattr(f, "__name__", "")
    if not name or "<lambda>" in name:
        return fallback
    return f"{fallback} ({name})"


@dataclasses.dataclass(frozen=True)
class SpecFormula:
    """One enumerated spec formula (round_tpu/spec/check.py::SpecFormula):
    the label is exactly the string the trace checker attaches to an
    evaluation error / report row.

    kind ∈ {"invariant", "property", "safety_predicate",
    "round_invariant"}; ``group`` is the round index for round_invariants
    (else -1); ``scope`` is the formula_scope classification."""

    label: str
    kind: str
    name: str
    formula: Any
    group: int = -1
    scope: str = "offline"


def spec_formulas(spec: Spec) -> Tuple[SpecFormula, ...]:
    """Every formula a Spec carries, in a fixed order, under the labels
    ``check_trace`` reports (round_tpu/spec/check.py::spec_formulas).
    Order: invariants, properties, safety_predicate, round_invariants
    (group-major)."""
    out = []
    for i, f in enumerate(spec.invariants):
        out.append(SpecFormula(
            formula_label(f, f"invariants[{i}]"), "invariant",
            f"invariants[{i}]", f,
            scope=formula_scope("invariant", f"invariants[{i}]")))
    for name, f in spec.properties:
        out.append(SpecFormula(
            f"property {name!r}", "property", name, f,
            scope=formula_scope("property", name)))
    if spec.safety_predicate is not None:
        f = spec.safety_predicate
        out.append(SpecFormula(
            formula_label(f, "safety_predicate"), "safety_predicate",
            "safety_predicate", f,
            scope=formula_scope("safety_predicate", "safety_predicate")))
    for j, group in enumerate(spec.round_invariants):
        for m, f in enumerate(group):
            out.append(SpecFormula(
                formula_label(f, f"round_invariants[{j}][{m}]"),
                "round_invariant", f"round_invariants[{j}][{m}]", f,
                group=j,
                scope=formula_scope("round_invariant",
                                    f"round_invariants[{j}][{m}]")))
    return tuple(out)


def _eval_formula(f, env, label) -> torch.Tensor:
    """Evaluate one formula to a bool scalar, re-raising SpecFieldError
    with the formula's name attached."""
    try:
        return torch.as_tensor(f(env)).to(torch.bool)
    except SpecFieldError as e:
        raise e.with_formula(label) from None


def replay_ho(key, ho_sampler, rounds: int) -> torch.Tensor:
    """Recompute the [T, n, n] HO schedule an engine run drew from ``key``
    (round_tpu/spec/check.py::replay_ho).

    The port's key discipline (engine/executor.run_phases): the scenario
    key — a ``(salt0, salt1)`` pair — is handed to the sampler unchanged
    every round, with the round number as the sampler's second argument.
    round_tpu splits its key first; a port key equal to the salts of
    round_tpu's ``ho_key`` replays the same masks."""
    return torch.stack([ho_sampler(key, r) for r in range(rounds)])


@dataclasses.dataclass
class SpecReport:
    """Per-step spec evaluation over one trace
    (round_tpu/spec/check.py::SpecReport).

    invariant_held: [T, n_inv] bool — invariant i holds at step t.
    any_invariant:  [T] bool — some invariant of the chain holds at t
                    (vacuously True when the spec has no invariants).
    properties:     name -> [T] bool per-step evaluation.
    safety_ok:      [T] bool — safety_predicate holds at t (True if absent).
    final_properties: name -> bool at the last step (e.g. Termination).
    round_invariant_ok: [T, n_groups] bool, True where a group does not
                    apply to the step's phase-round (None without groups).
    """

    invariant_held: torch.Tensor
    any_invariant: torch.Tensor
    properties: Dict[str, torch.Tensor]
    safety_ok: torch.Tensor
    final_properties: Dict[str, torch.Tensor]
    round_invariant_ok: Optional[torch.Tensor] = None

    def all_safety_properties_hold(self) -> torch.Tensor:
        """Conjunction over steps of every property except Termination
        (a liveness property, meaningful only at the end)."""
        ok = torch.tensor(True, device=self.safety_ok.device)
        for name, vals in self.properties.items():
            if name.lower() == "termination":
                continue
            ok = ok & vals.all()
        return ok


def cut_env(state: Any, n: int, r: int, init0: Any = None) -> Env:
    """The evaluation context of one round-aligned global snapshot
    (round_tpu/spec/check.py::cut_env): the [n, ...] state stamped round
    ``r`` is the post-state of round r — check_trace's step t=r — so
    formulas see ``env.r = r + 1``.  No ``old`` and no ``ho``."""
    return Env(state=state, n=n, old=None, init0=init0, ho=None,
               r=torch.tensor(r + 1, dtype=torch.int32))


def check_cut(spec: Spec, state: Any, n: int, r: int,
              init0: Any = None, rounds_per_phase: int = 1
              ) -> Dict[str, Any]:
    """Evaluate the offline formulas of ``spec`` on one cut
    (round_tpu/spec/check.py::check_cut).

    Returns {label: bool | None}: None marks a formula that is not
    cut-evaluable (it needs ``old``, the HO matrix, or an init snapshot
    that was not provided).  The invariant chain is one entry,
    ``"invariants (chain)"`` — the disjunction over the chain — and only
    when every chain member is cut-evaluable.  Round-invariant group j
    applies iff ``r % rounds_per_phase == j`` (True elsewhere)."""
    enum = spec_formulas(spec)
    state = tree_map(torch.as_tensor, state)
    if init0 is not None:
        init0 = tree_map(torch.as_tensor, init0)
    env = cut_env(state, n, r, init0=init0)
    out: Dict[str, Any] = {}

    def _try(e):
        try:
            return bool(_eval_formula(e.formula, env, e.label))
        except (ValueError, SpecFieldError):
            # "no previous-round snapshot" / "no HO matrix" / "no init
            # snapshot" / a field the state does not carry: not
            # cut-evaluable, by construction not a violation
            return None

    inv = [e for e in enum if e.kind == "invariant"]
    if inv:
        vals = [_try(e) for e in inv]
        out["invariants (chain)"] = (None if any(v is None for v in vals)
                                     else any(vals))
    for e in enum:
        if e.kind == "property" and e.scope == "offline":
            out[e.label] = _try(e)
        elif e.kind == "round_invariant":
            if r % rounds_per_phase == e.group:
                out[e.label] = _try(e)
            else:
                out[e.label] = True  # group does not apply to this round
    return out


def check_trace(
    spec: Spec,
    trace: Any,
    init_state: Any,
    n: int,
    ho: Optional[torch.Tensor] = None,
    rounds_per_phase: int = 1,
) -> SpecReport:
    """Evaluate ``spec`` at every step of one recorded trace
    (round_tpu/spec/check.py::check_trace).

    Round convention: the engine records the post-state of round t, which
    is the reference's pre-state of round t+1 — so formulas see
    ``env.r = t + 1``.  ``spec.round_invariants[j]`` is evaluated only at
    steps with t % rounds_per_phase == j and reported True elsewhere.  The
    safety_predicate is evaluated against ho[t] on the pre-state (the
    ``old`` snapshot) with env.r = t, since it constrains the round being
    executed.

    Args:
      spec: the Spec to check.
      trace: state pytree stacked over rounds, leaves [T, n, ...].
      init_state: the round-0 initial state, leaves [n, ...].
      n: number of processes.
      ho: optional [T, n, n] HO schedule (required if formulas use p.HO or
        the set domain; see replay_ho).
      rounds_per_phase: the algorithm's phase length.
    """
    T = tree_leaves(trace)[0].shape[0]
    dev = tree_leaves(trace)[0].device
    k = rounds_per_phase
    enum = spec_formulas(spec)
    inv_refs = [e for e in enum if e.kind == "invariant"]
    prop_refs = [e for e in enum if e.kind == "property"]
    safety_ref = next((e for e in enum if e.kind == "safety_predicate"), None)
    rinv_refs = [e for e in enum if e.kind == "round_invariant"]

    inv_rows, safe_rows, rinv_rows = [], [], []
    props: Dict[str, list] = {e.name: [] for e in prop_refs}
    old_t = init_state
    for t in range(T):
        state_t = tree_map(lambda x: x[t], trace)
        ho_t = None if ho is None else ho[t]
        r_t = torch.tensor(t + 1, dtype=torch.int32, device=dev)
        env = Env(state=state_t, n=n, old=old_t, init0=init_state, ho=ho_t,
                  r=r_t)
        inv_rows.append(
            torch.stack([_eval_formula(e.formula, env, e.label)
                         for e in inv_refs])
            if inv_refs else torch.ones((0,), dtype=torch.bool, device=dev))
        for e in prop_refs:
            props[e.name].append(_eval_formula(e.formula, env, e.label))
        if safety_ref is not None:
            pre_env = Env(state=old_t, n=n, old=None, init0=init_state,
                          ho=ho_t, r=r_t - 1)
            safe_rows.append(_eval_formula(safety_ref.formula, pre_env,
                                           safety_ref.label))
        else:
            safe_rows.append(torch.tensor(True, device=dev))
        if spec.round_invariants:
            row = []
            for j, group in enumerate(spec.round_invariants):
                if t % k == j and group:
                    row.append(torch.stack([
                        _eval_formula(e.formula, env, e.label)
                        for e in rinv_refs if e.group == j]).all())
                else:
                    row.append(torch.tensor(True, device=dev))
            rinv_rows.append(torch.stack(row))
        old_t = state_t

    inv = torch.stack(inv_rows)
    any_inv = (inv.any(dim=1) if inv.shape[1] > 0
               else torch.ones((T,), dtype=torch.bool, device=dev))
    properties = {name: torch.stack(v) for name, v in props.items()}
    return SpecReport(
        invariant_held=inv,
        any_invariant=any_inv,
        properties=properties,
        safety_ok=torch.stack(safe_rows),
        final_properties={k_: v[-1] for k_, v in properties.items()},
        round_invariant_ok=torch.stack(rinv_rows) if rinv_rows else None,
    )
