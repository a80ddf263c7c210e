"""Ground SMT solver: native CDCL SAT core + EUF + LIA theories, DPLL(T).

Reference parity: psync.utils.SmtSolver (utils/SmtSolver.scala:8-39) bridges
formulas to an external C++ solver binary (z3/cvc4) over a pipe.  This
framework is self-contained: the pipe goes to its own native core
(round_tpu_torch/native/sat.cpp, built on first use), and the theory layer —
congruence closure (congruence.py) and integer linear arithmetic (lia.py) —
runs host-side in a lazy CEGAR loop:

    ground formula → NNF → Tseitin CNF → native SAT → model
      → EUF + LIA checks → conflict? add blocking clause, repeat.

Verdicts: 'unsat' is authoritative (every blocking clause is a theory lemma);
'sat' means no theory conflict was found under the NO-lite combination
(equalities propagate EUF→LIA; reverse propagation is not implemented), and
'unknown' means a budget ran out.  The verifier treats only 'unsat' as a
proved VC, so incompleteness can never certify a wrong invariant.

When an external SMT solver (z3/cvc5/cvc4) is on PATH, `Solver` can use it
via SMT-LIB2 instead (the reference's own architecture); the native backend
is the default and the only one exercised in CI.

Port of round_tpu/verify/solver.py, copied with only the package name changed
and where ``rtsat`` is built: ``_sat_binary`` compiles the port's own copy
of ``sat.cpp`` into ``round_tpu_torch/_build/rtsat`` and never runs ``make``
in round_tpu's tree.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Set, Tuple

from round_tpu_torch.verify import congruence, lia
from round_tpu_torch.verify.formula import (
    AND, Application, Binding, Bool, DIVIDES, EQ, FALSE, Formula, GEQ, GT,
    IMPLIES, IN, Int, IntT, ITE, LEQ, LT, Literal, MINUS, NEQ, NOT, OR, PLUS,
    TIMES, TRUE, UMINUS, UnInterpretedFct, Variable,
)
from round_tpu_torch.verify.futils import fmap
from round_tpu_torch.verify.simplify import nnf, simplify
from round_tpu_torch.verify.typer import typecheck

SAT, UNSAT, UNKNOWN = "sat", "unsat", "unknown"

_ARITH_PRED = {LEQ, LT, GEQ, GT}
_ARITH_FUN = {PLUS, MINUS, UMINUS, TIMES, DIVIDES}
_CONNECTIVES = {AND, OR, NOT, IMPLIES}


# ---------------------------------------------------------------------------
# Native SAT binary
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SAT_SRC = os.path.join(_PKG_DIR, "native", "sat.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SAT_EXE = os.path.join(_BUILD_DIR, "rtsat")
# round_tpu/native/Makefile's rtsat recipe (CXXFLAGS as there)
_CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")


_built = False


def _sat_binary() -> str:
    """The port's rtsat (round_tpu/verify/solver.py::_sat_binary), (re)built
    when it is missing or older than sat.cpp (make's rule) under a
    cross-process file lock, as runtime/transport.py builds libroundnet.so.
    The compiler writes a private file that is renamed into place, so a
    concurrent reader never executes a torn binary.  A failed build raises
    ``subprocess.CalledProcessError``."""
    global _built
    if not _built:
        import fcntl

        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, ".satlock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if (not os.path.exists(_SAT_EXE) or os.path.getmtime(_SAT_EXE)
                    < os.path.getmtime(_SAT_SRC)):
                tmp = f"{_SAT_EXE}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SAT_SRC],
                               check=True, capture_output=True)
                os.replace(tmp, _SAT_EXE)
        _built = True
    return _SAT_EXE


class SatTimeout(Exception):
    pass


class SatSession:
    """One incremental native-solver process (rtsat -i): the DPLL(T) loop
    adds theory blocking clauses between solves, and the solver keeps its
    learned clauses and activities instead of restarting from scratch (the
    round-1 loop re-ran the whole CNF per conflict — ~100x slower on
    VC-sized queries)."""

    def __init__(self, nvars: int, clauses: Sequence[Sequence[int]]):
        self.nvars = nvars
        self.proc = subprocess.Popen(
            [_sat_binary(), "-i"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
            bufsize=1,
        )
        lines = [f"p cnf {nvars} {len(clauses)}"]
        for c in clauses:
            lines.append(" ".join(map(str, c)) + " 0")
        self.proc.stdin.write("\n".join(lines) + "\n")

    def add_clause(self, clause: Sequence[int]) -> None:
        self.proc.stdin.write("a " + " ".join(map(str, clause)) + " 0\n")

    def solve(self, timeout_s: Optional[float] = None) -> Optional[List[bool]]:
        """Returns assignment (index 1..nvars) or None for unsat; raises
        SatTimeout (killing the process) if the budget expires."""
        import threading

        self.proc.stdin.write("s\n")
        self.proc.stdin.flush()
        timer = None
        timed_out = [False]
        if timeout_s is not None:
            def _kill():
                timed_out[0] = True
                self.proc.kill()

            timer = threading.Timer(max(timeout_s, 0.001), _kill)
            timer.start()
        try:
            header = self.proc.stdout.readline()
            if timed_out[0] or not header:
                raise SatTimeout()
            if header.strip() == "r unsat":
                return None
            assert header.strip() == "r sat", header
            body = self.proc.stdout.readline()
            if timed_out[0] or not body:
                raise SatTimeout()
        finally:
            if timer is not None:
                timer.cancel()
        assign = [True] * (self.nvars + 1)
        for tok in body.split():
            if tok == "v":
                continue
            l = int(tok)
            if l != 0:
                assign[abs(l)] = l > 0
        return assign

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.proc.stdin.write("q\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=2)
        except Exception:
            self.proc.kill()


def sat_solve(
    nvars: int,
    clauses: Sequence[Sequence[int]],
    timeout_s: Optional[float] = None,
) -> Optional[List[bool]]:
    """Run the native CDCL core.  Returns assignment (index 1..nvars) or None.
    Raises SatTimeout when the wall-clock budget expires."""
    lines = [f"p cnf {nvars} {len(clauses)}"]
    for c in clauses:
        lines.append(" ".join(map(str, c)) + " 0")
    try:
        proc = subprocess.run(
            [_sat_binary()],
            input="\n".join(lines),
            capture_output=True,
            text=True,
            timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        raise SatTimeout()
    if proc.returncode == 20:
        return None
    assert proc.returncode == 10, proc.stderr
    assign = [True] * (nvars + 1)
    for tok in proc.stdout.split():
        try:
            l = int(tok)
        except ValueError:
            continue
        if l != 0:
            assign[abs(l)] = l > 0
    return assign


# ---------------------------------------------------------------------------
# Preprocessing: ITE lifting, NEQ removal
# ---------------------------------------------------------------------------

def _find_ite(f: Formula) -> Optional[Application]:
    if isinstance(f, Application):
        if f.fct == ITE:
            return f
        for a in f.args:
            r = _find_ite(a)
            if r is not None:
                return r
    return None


def lift_ite(f: Formula) -> Formula:
    """Pull term-level ITE up to the boolean level:
    atom[ite(c,t,e)] → (c ∧ atom[t]) ∨ (¬c ∧ atom[e])."""
    from round_tpu_torch.verify.futils import replace
    from round_tpu_torch.verify.formula import And, Not, Or

    if isinstance(f, Binding):
        g = Binding(f.binder, f.vars, lift_ite(f.body))
        g.tpe = f.tpe
        return g
    if isinstance(f, Application) and f.fct in _CONNECTIVES:
        g = Application(f.fct, [lift_ite(a) for a in f.args])
        g.tpe = f.tpe
        return g
    if isinstance(f, Application):
        ite = _find_ite(f)
        if ite is not None:
            c, t, e = ite.args
            return lift_ite(
                Or(
                    And(c, replace(f, ite, t)),
                    And(Not(c), replace(f, ite, e)),
                )
            )
    return f


def _no_neq(f: Formula) -> Formula:
    from round_tpu_torch.verify.formula import Not

    def step(g):
        if isinstance(g, Application) and g.fct == NEQ:
            e = Application(EQ, g.args)
            e.tpe = Bool
            return Not(e)
        return g

    return fmap(step, f)


# ---------------------------------------------------------------------------
# Tseitin (NNF, Plaisted-Greenbaum polarity encoding)
# ---------------------------------------------------------------------------

class _CnfBuilder:
    def __init__(self):
        self.n = 0
        self.clauses: List[List[int]] = []
        self.atom_var: Dict[Formula, int] = {}

    def new_var(self) -> int:
        self.n += 1
        return self.n

    def var_for_atom(self, a: Formula) -> int:
        if a not in self.atom_var:
            self.atom_var[a] = self.new_var()
        return self.atom_var[a]

    def encode(self, f: Formula) -> int:
        """Returns a literal equivalent (one-directionally) to f; f in NNF."""
        if f == TRUE:
            v = self.new_var()
            self.clauses.append([v])
            return v
        if f == FALSE:
            v = self.new_var()
            self.clauses.append([-v])
            return v
        if isinstance(f, Application) and f.fct == NOT:
            inner = f.args[0]
            return -self.var_for_atom(inner)
        if isinstance(f, Application) and f.fct == AND:
            v = self.new_var()
            for a in f.args:
                self.clauses.append([-v, self.encode(a)])
            return v
        if isinstance(f, Application) and f.fct == OR:
            v = self.new_var()
            self.clauses.append([-v] + [self.encode(a) for a in f.args])
            return v
        return self.var_for_atom(f)


# ---------------------------------------------------------------------------
# Arithmetic linearization
# ---------------------------------------------------------------------------

class _NonLinear(Exception):
    pass


def _term_name(t: Formula) -> str:
    return repr(t)


def _linearize(t: Formula, foreign: Dict[str, Formula]) -> Tuple[Dict[str, int], int]:
    """t (Int-typed term) → (coeffs over var names, constant).  Foreign
    (uninterpreted) subterms become fresh LIA variables recorded in
    `foreign` for EUF↔LIA equality propagation."""
    if isinstance(t, Literal):
        assert isinstance(t.value, int) and not isinstance(t.value, bool)
        return {}, int(t.value)
    if isinstance(t, Variable):
        return {t.name: 1}, 0
    if isinstance(t, Application):
        if t.fct == PLUS:
            coeffs: Dict[str, int] = {}
            const = 0
            for a in t.args:
                c, k = _linearize(a, foreign)
                const += k
                for n, v in c.items():
                    coeffs[n] = coeffs.get(n, 0) + v
            return coeffs, const
        if t.fct == MINUS:
            ca, ka = _linearize(t.args[0], foreign)
            cb, kb = _linearize(t.args[1], foreign)
            for n, v in cb.items():
                ca[n] = ca.get(n, 0) - v
            return ca, ka - kb
        if t.fct == UMINUS:
            c, k = _linearize(t.args[0], foreign)
            return {n: -v for n, v in c.items()}, -k
        if t.fct == TIMES:
            const = 1
            sym = None
            for a in t.args:
                c, k = _linearize(a, foreign)
                if not c:
                    const *= k
                elif sym is None:
                    sym = (c, k)
                else:
                    raise _NonLinear(repr(t))
            if sym is None:
                return {}, const
            c, k = sym
            return {n: v * const for n, v in c.items()}, k * const
        # uninterpreted Int term (incl. Divides): a shared EUF/LIA variable
        name = _term_name(t)
        foreign[name] = t
        return {name: 1}, 0
    raise _NonLinear(repr(t))


# ---------------------------------------------------------------------------
# The DPLL(T) loop
# ---------------------------------------------------------------------------

def _is_int(t: Formula) -> bool:
    return isinstance(t.tpe, IntT)


def solve_ground(
    f: Formula, max_rounds: int = 500_000, timeout_s: Optional[float] = None
) -> str:
    """Satisfiability of a ground (quantifier-free) formula.  Quantified
    subformulas must have been eliminated by the CL reducer first.  The
    wall-clock budget covers all native SAT calls together; expiry → unknown.
    With no explicit budget a 600 s default applies — the round cap is no
    longer a practical termination backstop."""
    import time as _time
    if timeout_s is None:
        timeout_s = 600.0
    deadline = _time.monotonic() + timeout_s
    f = simplify(f)
    f = typecheck(f)
    f = lift_ite(f)
    f = _no_neq(f)
    f = nnf(f)
    if f == TRUE:
        return SAT
    if f == FALSE:
        return UNSAT

    cnf = _CnfBuilder()
    root = cnf.encode(f)
    cnf.clauses.append([root])

    # Atom theory records are computed once; one incremental solver session
    # serves the whole loop (learned clauses persist).
    foreign: Dict[str, Formula] = {}
    records = [
        (a, v, _classify_atom(a, foreign)) for a, v in cnf.atom_var.items()
    ]
    sess = SatSession(cnf.n, cnf.clauses)
    try:
        for _ in range(max_rounds):
            try:
                budget = (
                    None if deadline is None else deadline - _time.monotonic()
                )
                if budget is not None and budget <= 0:
                    return UNKNOWN
                assign = sess.solve(timeout_s=budget)
            except SatTimeout:
                return UNKNOWN
            if assign is None:
                return UNSAT
            # literal values for each atom
            atoms = [(a, assign[v], rec) for a, v, rec in records]
            conflict = _theory_check(atoms, foreign)
            if conflict is None:
                return SAT
            # blocking clause: negate the conjunction of conflicting literals
            blocking = []
            for a in conflict:
                v = cnf.atom_var[a]
                blocking.append(-v if assign[v] else v)
            assert blocking, "empty theory conflict"
            sess.add_clause(blocking)
        return UNKNOWN
    finally:
        sess.close()


def _classify_atom(atom: Formula, foreign: Dict[str, Formula]):
    """Per-atom theory record, computed ONCE per solve (the linearization
    walks dominated the per-model theory check when recomputed each round).

    Records:
      ("eq", a, b, lin, neg)  — equality (lin = (coeffs, rhs) or None;
                                 neg flips the assignment for Neq atoms)
      ("arith", pos, neg_c)    — arith predicate; pos/neg_c = (coeffs, op,
                                 rhs) for the True/False assignment, or None
      ("pred",)                — uninterpreted predicate, EUF-registerable
      ("opaque",)              — contributes nothing (quantified innards)
    """

    def lin_pair(a, b):
        ca, ka = _linearize(a, foreign)
        cb, kb = _linearize(b, foreign)
        for n, v in cb.items():
            ca[n] = ca.get(n, 0) - v
        return ca, kb - ka  # ca·x ⋈ (kb - ka)

    neg = False
    atom_eq = atom
    if isinstance(atom, Application) and atom.fct == NEQ:
        # nnf may reintroduce Neq from ¬(a=b): same theory atom, flipped
        atom_eq = Application(EQ, atom.args)
        atom_eq.tpe = Bool
        neg = True
    if isinstance(atom_eq, Application) and atom_eq.fct == EQ:
        a, b = atom_eq.args
        lin = None
        if _is_int(a) or _is_int(b):
            try:
                lin = lin_pair(a, b)
            except _NonLinear:
                lin = None
        return ("eq", a, b, lin, neg)
    if isinstance(atom, Application) and atom.fct in _ARITH_PRED:
        a, b = atom.args
        try:
            coeffs, rhs = lin_pair(a, b)
        except _NonLinear:
            return ("opaque",)
        op = atom.fct
        if op == GEQ:
            coeffs, rhs, op = {n: -v for n, v in coeffs.items()}, -rhs, LEQ
        elif op == GT:
            coeffs, rhs, op = {n: -v for n, v in coeffs.items()}, -rhs, LT
        if op == LEQ:
            pos = (coeffs, "<=", rhs)
            neg_c = (coeffs, ">=", rhs + 1)
        else:  # LT
            pos = (coeffs, "<=", rhs - 1)
            neg_c = (coeffs, ">=", rhs)
        return ("arith", pos, neg_c)
    if isinstance(atom, (Application, Variable)):
        if isinstance(atom, Application) and any(
            isinstance(x, Binding) for x in atom.args
        ):
            return ("opaque",)
        return ("pred",)
    return ("opaque",)


def _theory_check(
    atoms: List[Tuple[Formula, bool, tuple]],
    foreign: Dict[str, Formula],
) -> Optional[List[Formula]]:
    """Check a full atom assignment against EUF + LIA.
    Returns None (consistent) or the list of atom Formulas in conflict.
    `atoms` carry their precomputed _classify_atom records."""
    eqs: List[Tuple[Formula, Formula]] = []
    eq_atoms: List[Formula] = []
    diseqs: List[Tuple[Formula, Formula]] = []
    diseq_atoms: List[Formula] = []

    lia_cons: List[Tuple[Dict[str, int], str, int]] = []
    lia_atoms: List[Tuple[Formula, bool]] = []
    int_neg_eqs: List[Tuple[Dict[str, int], int]] = []
    int_neg_atoms: List[Formula] = []

    for atom, val, rec in atoms:
        kind = rec[0]
        if kind == "opaque":
            continue
        if kind == "eq":
            _k, a, b, lin, neg = rec
            eff_val = val != neg
            if lin is not None:
                coeffs, rhs = lin
                if eff_val:
                    lia_cons.append((coeffs, "==", rhs))
                    lia_atoms.append((atom, True))
                else:
                    int_neg_eqs.append((coeffs, rhs))
                    int_neg_atoms.append(atom)
            # equalities also inform EUF congruence (Int-typed ones too)
            if eff_val:
                eqs.append((a, b))
                eq_atoms.append(atom)
            else:
                diseqs.append((a, b))
                diseq_atoms.append(atom)
        elif kind == "arith":
            lia_cons.append(rec[1] if val else rec[2])
            lia_atoms.append((atom, val))
        else:  # pred
            target = TRUE if val else FALSE
            eqs.append((atom, target))
            eq_atoms.append(atom)

    # --- EUF ---------------------------------------------------------------
    all_diseqs = diseqs + [(TRUE, FALSE)]
    res = congruence.euf_check(eqs, all_diseqs, extra_terms=(TRUE, FALSE))
    if res is not None:
        core, bad = res
        conflict = [eq_atoms[i] for i in core]
        if bad < len(diseq_atoms):
            conflict.append(diseq_atoms[bad])
        return conflict or None

    # --- EUF → LIA propagation: equalities between foreign Int terms -------
    prop_base = len(lia_cons)
    prop_atoms: List[List[Formula]] = []
    if foreign:
        cc = congruence.CongruenceClosure()
        for idx, (a, b) in enumerate(eqs):
            try:
                cc.assert_eq(a, b, tag=idx)
            except ValueError:
                pass
        names = sorted(foreign)
        # register ALL terms first (congruence may merge foreign terms with
        # each other: x=y must propagate g(x)=g(y) to LIA), then read reps
        registered = []
        for n in names:
            try:
                cc.add_term(foreign[n])
                registered.append(n)
            except ValueError:
                continue
        by_repr: Dict[Formula, List[str]] = {}
        for n in registered:
            by_repr.setdefault(cc.find(foreign[n]), []).append(n)
        for group in by_repr.values():
            for other in group[1:]:
                lia_cons.append(({group[0]: 1, other: -1}, "==", 0))
                # precise proof-forest explanation of the merge: blocking
                # with all positive equalities (the round-1 fallback) made
                # these conflicts nearly vacuous on VC-sized queries
                core = cc.explain(foreign[group[0]], foreign[other])
                if core is None:
                    prop_atoms.append(eq_atoms)
                else:
                    prop_atoms.append([eq_atoms[i] for i in sorted(core)])

    # --- LIA with lazy negated-equality splits -----------------------------
    # A negated Int equality (Σc·x ≠ r) is non-convex; instead of eagerly
    # branching on all of them, solve without, and only split on one the
    # model actually violates (standard lazy splitting).  `extra_src[i]`
    # records which negated-equality atom produced extras[i].
    budget = [200]  # total search nodes

    def lazy(extra, extra_src, branched):
        if budget[0] <= 0:
            return "unknown"
        budget[0] -= 1
        status, payload = lia.solve_lia(lia_cons + extra)
        if status == lia.UNKNOWN:
            return "unknown"
        if status == lia.UNSAT:
            conflict: List[Formula] = []
            for cid in payload:
                if cid < prop_base:
                    conflict.append(lia_atoms[cid][0])
                elif cid < len(lia_cons):
                    conflict.extend(prop_atoms[cid - prop_base])
                else:
                    conflict.append(extra_src[cid - len(lia_cons)])
            return conflict
        model = payload
        violated = None
        for k, (coeffs, rhs) in enumerate(int_neg_eqs):
            if k in branched:
                continue
            val = sum(c * model.get(nm, 0) for nm, c in coeffs.items())
            if val == rhs:
                violated = k
                break
        if violated is None:
            return None  # consistent
        coeffs, rhs = int_neg_eqs[violated]
        atom = int_neg_atoms[violated]
        b2 = branched | {violated}
        r1 = lazy(extra + [(coeffs, "<=", rhs - 1)], extra_src + [atom], b2)
        if r1 is None or r1 == "unknown":
            return r1
        r2 = lazy(extra + [(coeffs, ">=", rhs + 1)], extra_src + [atom], b2)
        if r2 is None or r2 == "unknown":
            return r2
        merged = r1 + [a for a in r2 if a not in r1]
        if atom not in merged:
            merged.append(atom)
        return merged

    r = lazy([], [], frozenset())
    if r == "unknown" or r is None:
        return None  # cannot refute this model (sound: sat is never trusted)
    # dedup while keeping Formula objects
    seen = set()
    out = []
    for a in r:
        if a not in seen:
            seen.add(a)
            out.append(a)
    return out


# ---------------------------------------------------------------------------
# SMT-LIB2 emission + external solvers (optional)
# ---------------------------------------------------------------------------

def to_smtlib2(f: Formula, logic: str = "ALL") -> str:
    """Serialize a ground formula to SMT-LIB2 (for external solvers and for
    --dumpVcs-style debugging, VerificationOptions.scala:20)."""
    f = typecheck(f)
    decls: Dict[str, str] = {}
    sorts: Set[str] = set()

    def sort_of(t) -> str:
        from round_tpu_torch.verify import formula as F

        if isinstance(t, F.BoolT):
            return "Bool"
        if isinstance(t, F.IntT):
            return "Int"
        if isinstance(t, F.UnInterpreted):
            sorts.add(t.name)
            return t.name
        sorts.add("U!" + repr(t).replace(" ", ""))
        return "U!" + repr(t).replace(" ", "")

    def mangle(name: str) -> str:
        return "|" + name.replace("|", "!") + "|"

    def go(g: Formula) -> str:
        if isinstance(g, Literal):
            if g.value is True:
                return "true"
            if g.value is False:
                return "false"
            v = int(g.value)
            return str(v) if v >= 0 else f"(- {-v})"
        if isinstance(g, Variable):
            decls[mangle(g.name)] = f"() {sort_of(g.tpe)}"
            return mangle(g.name)
        if isinstance(g, Application):
            ops = {
                AND: "and", OR: "or", NOT: "not", IMPLIES: "=>", EQ: "=",
                PLUS: "+", MINUS: "-", UMINUS: "-", TIMES: "*", LEQ: "<=",
                LT: "<", GEQ: ">=", GT: ">", ITE: "ite",
            }
            if g.fct == NEQ:
                return f"(not (= {go(g.args[0])} {go(g.args[1])}))"
            if g.fct in ops:
                if not g.args:
                    return {"and": "true", "or": "false"}[ops[g.fct]]
                return f"({ops[g.fct]} " + " ".join(go(a) for a in g.args) + ")"
            name = mangle(g.fct.name)
            args = " ".join(sort_of(a.tpe) for a in g.args)
            decls[name] = f"({args}) {sort_of(g.tpe)}"
            if not g.args:
                return name
            return f"({name} " + " ".join(go(a) for a in g.args) + ")"
        if isinstance(g, Binding):
            from round_tpu_torch.verify.formula import COMPREHENSION

            assert g.binder != COMPREHENSION, "symbolize comprehensions first"
            q = "forall" if g.binder == "ForAll" else "exists"
            vs = " ".join(f"({mangle(v.name)} {sort_of(v.tpe)})" for v in g.vars)
            return f"({q} ({vs}) {go(g.body)})"
        raise TypeError(repr(g))

    body = go(f)
    lines = [f"(set-logic {logic})"]
    for s in sorted(sorts):
        lines.append(f"(declare-sort {s} 0)")
    for name, sig in sorted(decls.items()):
        lines.append(f"(declare-fun {name} {sig})")
    lines.append(f"(assert {body})")
    lines.append("(check-sat)")
    return "\n".join(lines)


def external_solver() -> Optional[List[str]]:
    """Command line for an external SMT solver if one is on PATH
    (the reference's z3/cvc4 pipe, utils/SmtSolver.scala:14-26)."""
    for cand in (["z3", "-smt2", "-in"], ["cvc5", "--lang=smt2"],
                 ["cvc4", "--lang=smt2"]):
        if shutil.which(cand[0]):
            return cand
    return None


class Solver:
    """Entry point used by the VC layer.  backend='native' (default) runs the
    DPLL(T) loop over the built-in SAT core; backend='external' pipes
    SMT-LIB2 to z3/cvc if available."""

    def __init__(self, backend: str = "native", timeout_s: float = 60.0):
        self.backend = backend
        self.timeout_s = timeout_s

    def check_sat(self, f: Formula) -> str:
        if self.backend == "external":
            cmd = external_solver()
            if cmd is not None:
                try:
                    p = subprocess.run(
                        cmd,
                        input=to_smtlib2(f),
                        capture_output=True,
                        text=True,
                        timeout=self.timeout_s,
                    )
                    out = p.stdout.strip().splitlines()
                    if out and out[-1] in (SAT, UNSAT, UNKNOWN):
                        return out[-1]
                except subprocess.TimeoutExpired:
                    return UNKNOWN
            # fall through to native
        return solve_ground(f, timeout_s=self.timeout_s)

    def is_valid(self, f: Formula) -> bool:
        """f is valid iff ¬f is unsat."""
        from round_tpu_torch.verify.formula import Not

        return self.check_sat(Not(f)) == UNSAT
