"""Specification layer: properties and invariants as masked tensor
reductions (port of round_tpu/spec).

The reference's spec DSL (Specs.scala:8-41, SpecHelper init/old, the Domain
forall/exists/filter stubs of Algorithm.scala:91-95) exists to prove
algorithms offline via SMT.  Here the same formulas are checked —
evaluated exactly, per round, over every lane of a recorded scenario, with
quantifiers as vmapped reductions over the state tensors.

Quantifier mapping:
    P.forall(f)        -> all over a vmapped lane axis
    P.exists(f)        -> any
    P.filter(f).size   -> sum of the predicate mask (Cardinality)
    V.exists(f)        -> any over an explicit candidate-value axis
    S.exists(f)        -> any over the HO rows (set-domain witnesses)
    init(x) / old(x)   -> reads of the init / previous-round snapshot tensors
"""

from round_tpu_torch.spec.dsl import (
    Env,
    ProcDomain,
    ProcView,
    SetDomain,
    SetView,
    Spec,
    SpecFieldError,
    TrivialSpec,
    ValueDomain,
    implies,
)
from round_tpu_torch.spec.check import (
    SpecReport, check_cut, check_trace, cut_env, replay_ho, spec_formulas,
)

__all__ = [
    "Env",
    "ProcDomain",
    "ProcView",
    "SetDomain",
    "SetView",
    "Spec",
    "SpecFieldError",
    "TrivialSpec",
    "ValueDomain",
    "implies",
    "SpecReport",
    "check_cut",
    "check_trace",
    "cut_env",
    "replay_ho",
    "spec_formulas",
]
