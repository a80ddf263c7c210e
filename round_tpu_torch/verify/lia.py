"""Linear integer arithmetic solver: general simplex + branch-and-bound.

This is the arithmetic theory inside the SMT backend (round_tpu_torch.verify.solver)
— the role z3's arithmetic core plays for the reference's verifier
(utils/SmtSolver.scala pipes to z3; here the framework is self-contained).

Algorithm: the DPLL(T)-oriented "general simplex" (Dutertre & de Moura,
CAV'06): every constraint Σ c·x ⋈ b becomes a bound on a slack variable,
the tableau keeps basic variables as linear forms over nonbasic ones, and
feasibility search pivots with Bland's rule (termination guaranteed).
Integrality is restored by branch-and-bound on a fractional variable with a
recursion cap; exceeding the cap reports 'unknown' (never a wrong verdict).

Conflicts are *explained*: an infeasible row yields the set of constraint ids
whose bounds participate, so the SAT core learns small blocking clauses.

Port of round_tpu/verify/lia.py, copied with only the package name changed.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

# A linear expression is Dict[str, Fraction] (var -> coeff); constants are
# folded into the bound side before reaching the solver.

SAT, UNSAT, UNKNOWN = "sat", "unsat", "unknown"
_BRANCH = -1  # pseudo constraint id for branch-and-bound bounds


class _Bound:
    __slots__ = ("value", "cid")

    def __init__(self, value: Fraction, cid: int):
        self.value = value
        self.cid = cid


class Simplex:
    """One (re-startable) rational feasibility problem."""

    def __init__(self):
        self.vars: List[str] = []
        self.index: Dict[str, int] = {}
        self.lower: Dict[int, _Bound] = {}
        self.upper: Dict[int, _Bound] = {}
        # tableau: basic var -> {nonbasic var -> coeff}
        self.rows: Dict[int, Dict[int, Fraction]] = {}
        self.basic: Set[int] = set()
        self.beta: Dict[int, Fraction] = {}
        self._slack_by_form: Dict[Tuple, int] = {}
        self.conflict: Optional[List[int]] = None

    # -- construction -------------------------------------------------------

    def var(self, name: str) -> int:
        if name not in self.index:
            self.index[name] = len(self.vars)
            self.vars.append(name)
            self.beta[self.index[name]] = Fraction(0)
        return self.index[name]

    def _slack(self, form: Dict[int, Fraction]) -> int:
        key = tuple(sorted(form.items()))
        if key in self._slack_by_form:
            return self._slack_by_form[key]
        s = self.var(f"_s{len(self._slack_by_form)}")
        self._slack_by_form[key] = s
        # s is basic: s = Σ form, with basic vars substituted by their rows
        # (tableau rows may only reference nonbasic variables)
        expanded: Dict[int, Fraction] = {}
        for v, c in form.items():
            if v in self.basic:
                for w, cc in self.rows[v].items():
                    expanded[w] = expanded.get(w, Fraction(0)) + c * cc
            else:
                expanded[v] = expanded.get(v, Fraction(0)) + c
        self.rows[s] = {v: c for v, c in expanded.items() if c != 0}
        self.basic.add(s)
        self.beta[s] = sum(
            (c * self.beta[v] for v, c in form.items()), Fraction(0)
        )
        return s

    def add_constraint(
        self, coeffs: Dict[str, Fraction], op: str, rhs: Fraction, cid: int
    ) -> bool:
        """op in '<=', '>=', '=='.  Returns False on immediate conflict
        (self.conflict set)."""
        form = {self.var(n): Fraction(c) for n, c in coeffs.items() if c != 0}
        if not form:
            zero_ok = {
                "<=": Fraction(0) <= rhs,
                ">=": Fraction(0) >= rhs,
                "==": rhs == 0,
            }[op]
            if not zero_ok:
                self.conflict = [cid]
                return False
            return True
        if len(form) == 1:
            (v, c), = form.items()
            x, b = v, rhs / c
            flip = c < 0
        else:
            x, b, flip = self._slack(form), rhs, False
        if op == "==":
            return self._assert_lower(x, b, cid) and self._assert_upper(x, b, cid)
        le = (op == "<=") != flip
        if le:
            return self._assert_upper(x, b, cid)
        return self._assert_lower(x, b, cid)

    def _assert_upper(self, x: int, c: Fraction, cid: int) -> bool:
        lo = self.lower.get(x)
        if lo is not None and lo.value > c:
            self.conflict = [lo.cid, cid]
            return False
        up = self.upper.get(x)
        if up is None or c < up.value:
            self.upper[x] = _Bound(c, cid)
            if x not in self.basic and self.beta[x] > c:
                self._update(x, c)
        return True

    def _assert_lower(self, x: int, c: Fraction, cid: int) -> bool:
        up = self.upper.get(x)
        if up is not None and up.value < c:
            self.conflict = [up.cid, cid]
            return False
        lo = self.lower.get(x)
        if lo is None or c > lo.value:
            self.lower[x] = _Bound(c, cid)
            if x not in self.basic and self.beta[x] < c:
                self._update(x, c)
        return True

    # -- simplex core -------------------------------------------------------

    def _update(self, x: int, v: Fraction) -> None:
        d = v - self.beta[x]
        for bi, row in self.rows.items():
            a = row.get(x)
            if a:
                self.beta[bi] += a * d
        self.beta[x] = v

    def _pivot(self, bi: int, nj: int) -> None:
        row = self.rows.pop(bi)
        self.basic.discard(bi)
        a = row.pop(nj)
        new_row = {v: -c / a for v, c in row.items()}
        new_row[bi] = Fraction(1) / a
        self.rows[nj] = new_row
        self.basic.add(nj)
        for ob, orow in self.rows.items():
            if ob == nj:
                continue
            c = orow.pop(nj, None)
            if c:
                for v, cc in new_row.items():
                    orow[v] = orow.get(v, Fraction(0)) + c * cc
                    if orow[v] == 0:
                        del orow[v]

    def check(self) -> bool:
        """Rational feasibility.  False → self.conflict holds constraint ids."""
        if self.conflict is not None:
            return False
        while True:
            cand = None
            for bi in sorted(self.basic):  # Bland's rule
                lo, up = self.lower.get(bi), self.upper.get(bi)
                if lo is not None and self.beta[bi] < lo.value:
                    cand = (bi, True, lo.value)
                    break
                if up is not None and self.beta[bi] > up.value:
                    cand = (bi, False, up.value)
                    break
            if cand is None:
                return True
            bi, need_up, target = cand
            row = self.rows[bi]
            pivot = None
            for nj in sorted(row):
                a = row[nj]
                if need_up:
                    ok = (a > 0 and self._below_upper(nj)) or (
                        a < 0 and self._above_lower(nj)
                    )
                else:
                    ok = (a < 0 and self._below_upper(nj)) or (
                        a > 0 and self._above_lower(nj)
                    )
                if ok:
                    pivot = nj
                    break
            if pivot is None:
                ids = set()
                b = self.lower[bi] if need_up else self.upper[bi]
                ids.add(b.cid)
                for nj, a in row.items():
                    if need_up:
                        bb = self.upper.get(nj) if a > 0 else self.lower.get(nj)
                    else:
                        bb = self.lower.get(nj) if a > 0 else self.upper.get(nj)
                    if bb is not None:
                        ids.add(bb.cid)
                self.conflict = sorted(ids)
                return False
            theta = (target - self.beta[bi]) / row[pivot]
            self.beta[bi] = target
            self.beta[pivot] += theta
            for ob, orow in self.rows.items():
                if ob != bi:
                    a = orow.get(pivot)
                    if a:
                        self.beta[ob] += a * theta
            self._pivot(bi, pivot)

    def _below_upper(self, x: int) -> bool:
        up = self.upper.get(x)
        return up is None or self.beta[x] < up.value

    def _above_lower(self, x: int) -> bool:
        lo = self.lower.get(x)
        return lo is None or self.beta[x] > lo.value

    def model(self) -> Dict[str, Fraction]:
        return {
            n: self.beta[i]
            for n, i in self.index.items()
            if not n.startswith("_s")
        }


def solve_lia(
    constraints: List[Tuple[Dict[str, int], str, int]],
    max_depth: int = 60,
) -> Tuple[str, object]:
    """Integer feasibility of [(coeffs, op, rhs)] with op in '<=','>=','=='.

    Returns (SAT, model_dict) | (UNSAT, core_ids) | (UNKNOWN, None).
    core_ids indexes into `constraints`.
    """

    def attempt(extra: List[Tuple[Dict[str, int], str, int]], depth: int):
        sx = Simplex()
        ok = True
        for cid, (coeffs, op, rhs) in enumerate(constraints):
            if not sx.add_constraint(
                {k: Fraction(v) for k, v in coeffs.items()}, op, Fraction(rhs), cid
            ):
                ok = False
                break
        if ok:
            for coeffs, op, rhs in extra:
                if not sx.add_constraint(
                    {k: Fraction(v) for k, v in coeffs.items()},
                    op,
                    Fraction(rhs),
                    _BRANCH,
                ):
                    ok = False
                    break
        if not ok or not sx.check():
            core = [c for c in (sx.conflict or []) if c != _BRANCH]
            return UNSAT, core
        m = sx.model()
        frac = next(
            (n for n, v in m.items() if v.denominator != 1), None
        )
        if frac is None:
            return SAT, {n: int(v) for n, v in m.items()}
        if depth <= 0:
            return UNKNOWN, None
        v = m[frac]
        floor = v.numerator // v.denominator
        lo_res = attempt(extra + [({frac: 1}, "<=", floor)], depth - 1)
        if lo_res[0] in (SAT, UNKNOWN):
            return lo_res
        hi_res = attempt(extra + [({frac: 1}, ">=", floor + 1)], depth - 1)
        if hi_res[0] in (SAT, UNKNOWN):
            return hi_res
        return UNSAT, sorted(set(lo_res[1]) | set(hi_res[1]))

    return attempt([], max_depth)
