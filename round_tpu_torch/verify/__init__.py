"""Offline verification stack: formulas, the CL decision procedure, VCs.

This is the TPU build's counterpart of the reference's verification half
(psync.formula + psync.logic + psync.macros + psync.verification,
SURVEY.md SS2.4-2.7).  The *runtime* checking of specs on simulated traces
lives in round_tpu/spec; this package is the proof side: transition
relations, inductive-invariant verification conditions, and a decision
procedure for the CL fragment (set comprehensions + cardinalities over a
finite-but-unbounded process universe).

Layout:
  formula.py   - AST, types, symbol catalog      (formula/Formula.scala, Types.scala)
  typer.py     - unification-based type checker  (formula/Typer.scala)
  simplify.py  - nnf/pnf/cnf, simplifiers        (formula/Simplify.scala)
  futils.py    - traversals, substitution, vars  (formula/FormulaUtils.scala, Transforms.scala)
  logic/       - CL reducer                      (logic/*.scala)
  solver.py    - built-in SMT core + SMT-LIB     (utils/SmtSolver.scala; z3 replaced
                 by an in-repo DPLL+CC+Fourier-Motzkin core since no solver binary
                 ships in this image)
  tr.py        - round transition relations      (verification/TransitionRelation.scala)
  verifier.py  - VC generation + solving         (verification/Verifier.scala, VC.scala)

Port of round_tpu/verify/__init__.py, copied with only the package name changed.
"""

from round_tpu_torch.verify.formula import (  # noqa: F401
    And, Application, Binding, Bool, Comprehension, Eq, Exists, FMap, FNone,
    FOption, FSet, FSome, ForAll, Formula, FunT, Geq, Gt, Implies, Int, IntLit,
    Leq, Literal, Lt, Neq, Not, Or, Product, TRUE, FALSE, TVar, UnInterpreted,
    UnInterpretedFct, Variable, procType, timeType,
)
