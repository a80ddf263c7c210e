"""Congruence closure over ground terms.

Reference parity: psync.logic.CongruenceClosure (logic/CongruenceClosure.scala:13-429).
Same role: (a) the EUF theory solver inside the SMT backend, and (b) the
ground-term index that drives quantifier instantiation (repr-based dedup of
instantiation candidates).

Union-find with a congruence table keyed on (symbol, arg-representatives);
merging two classes re-canonicalizes the parents of both classes (classic
Nelson-Oppen style closure).  Terms are the immutable Formula values from
round_tpu_torch.verify.formula, so structural hashing is free.

Port of round_tpu/verify/congruence.py, copied with only the package name changed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from round_tpu_torch.verify.formula import (
    Application, Binding, EQ, Formula, Literal, NEQ, Variable,
)
from round_tpu_torch.verify.futils import get_conjuncts


class CongruenceClosure:
    def __init__(self):
        self._parent: Dict[Formula, Formula] = {}
        self._members: Dict[Formula, List[Formula]] = {}
        # (symbol, arg reprs) -> canonical application in that congruence class
        self._sig: Dict[Tuple, Formula] = {}
        # term -> applications it appears in as an argument
        self._uses: Dict[Formula, List[Formula]] = {}
        # proof forest: term -> (next term towards proof root, reason)
        self._proof: Dict[Formula, Tuple[Formula, Tuple]] = {}

    # -- union-find ---------------------------------------------------------

    def contains(self, t: Formula) -> bool:
        return t in self._parent

    def find(self, t: Formula) -> Formula:
        """Representative of t's class (t must be registered)."""
        root = t
        while self._parent[root] is not root:
            root = self._parent[root]
        while self._parent[t] is not root:  # path compression
            self._parent[t], t = root, self._parent[t]
        return root

    def repr_of(self, t: Formula) -> Formula:
        if not self.contains(t):
            self.add_term(t)
        return self.find(t)

    def congruent(self, a: Formula, b: Formula) -> bool:
        # register BOTH before comparing: adding b may trigger the congruence
        # merge that changes a's representative
        self.add_term(a)
        self.add_term(b)
        return self.find(a) == self.find(b)

    # -- registration -------------------------------------------------------

    def add_term(self, t: Formula) -> Formula:
        """Register t and its subterms; returns t's representative."""
        if isinstance(t, Binding):
            raise ValueError(f"congruence closure is ground-only, got {t!r}")
        if t in self._parent:
            return self.find(t)
        self._parent[t] = t
        self._members[t] = [t]
        if isinstance(t, Application):
            for a in t.args:
                self.add_term(a)
                self._uses.setdefault(self.find(a), []).append(t)
            sig = self._signature(t)
            existing = self._sig.get(sig)
            if existing is not None:
                self._union(t, existing, ("cong", t, existing))
            else:
                self._sig[sig] = t
        return self.find(t)

    def _signature(self, t: Application) -> Tuple:
        return (t.fct, tuple(self.find(a) for a in t.args))

    # -- merging ------------------------------------------------------------
    #
    # A proof forest (Nieuwenhuis & Oliveras) runs alongside the union-find:
    # every union records WHY its two endpoint terms are equal — either an
    # asserted equation (tagged) or a congruence step between two
    # applications.  `explain(a, b)` then extracts the exact set of asserted
    # equation tags needed, which is what keeps the DPLL(T) blocking clauses
    # small on large instances.

    def assert_eq(self, a: Formula, b: Formula, tag=None) -> None:
        self.add_term(a)
        self.add_term(b)
        self._union(a, b, ("eq", tag))

    def _union(self, a: Formula, b: Formula, reason=("eq", None)) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        # proof forest: reroot a's proof tree at a, then a —reason→ b
        self._reroot(a)
        self._proof[a] = (b, reason)
        # merge the smaller class into the larger
        if len(self._members[ra]) < len(self._members[rb]):
            ra, rb = rb, ra
        self._parent[rb] = ra
        self._members[ra].extend(self._members.pop(rb))
        # re-canonicalize applications using rb; may trigger further merges
        pending: List[Tuple[Formula, Formula]] = []
        uses = self._uses.pop(rb, [])
        for app in uses:
            sig = self._signature(app)
            existing = self._sig.get(sig)
            if existing is None:
                self._sig[sig] = app
            elif self.find(existing) != self.find(app):
                pending.append((existing, app))
        self._uses.setdefault(ra, []).extend(uses)
        for x, y in pending:
            self._union(x, y, ("cong", x, y))

    def _reroot(self, a: Formula) -> None:
        """Reverse the proof-forest path from a to its proof root."""
        path = []
        node = a
        while node in self._proof:
            nxt, reason = self._proof[node]
            path.append((node, nxt, reason))
            node = nxt
        for node, nxt, reason in reversed(path):
            del self._proof[node]
            self._proof[nxt] = (node, reason)

    # -- explanations --------------------------------------------------------

    def explain(self, a: Formula, b: Formula) -> Optional[Set]:
        """The set of asserted-equation tags implying a = b (None if they
        are not congruent).  Exact (proof-forest walk), not a minimization."""
        if not self.contains(a) or not self.contains(b) \
                or self.find(a) != self.find(b):
            return None
        out: Set = set()
        seen: Set[Tuple[Formula, Formula]] = set()
        self._explain_into(a, b, out, seen)
        return out

    def _proof_path(self, a: Formula) -> List[Formula]:
        path = [a]
        node = a
        while node in self._proof:
            node = self._proof[node][0]
            path.append(node)
        return path

    def _explain_into(self, a, b, out: Set, seen: Set) -> None:
        if a == b or (a, b) in seen:
            return
        seen.add((a, b))
        pa = self._proof_path(a)
        pb = self._proof_path(b)
        in_pa = {t: i for i, t in enumerate(pa)}
        meet = next((t for t in pb if t in in_pa), None)
        assert meet is not None, "explain: no common proof ancestor"

        def walk(start, stop):
            node = start
            while node != stop:
                nxt, reason = self._proof[node]
                if reason[0] == "eq":
                    if reason[1] is not None:
                        out.add(reason[1])
                else:  # congruence between two applications
                    _c, app1, app2 = reason
                    for x, y in zip(app1.args, app2.args):
                        self._explain_into(x, y, out, seen)
                node = nxt

        walk(a, meet)
        walk(b, meet)

    # -- queries ------------------------------------------------------------

    def classes(self) -> List[List[Formula]]:
        return [list(m) for m in self._members.values()]

    def ground_terms(self) -> Set[Formula]:
        return set(self._parent.keys())

    def class_of(self, t: Formula) -> List[Formula]:
        return list(self._members[self.find(t)])

    def normalize(self, f: Formula) -> Formula:
        """Rewrite every registered subterm of f to its representative
        (CongruenceClosure.normalize in the reference)."""
        if isinstance(f, (Literal, Variable)):
            return self.find(f) if self.contains(f) else f
        if isinstance(f, Application):
            args = [self.normalize(a) for a in f.args]
            g = Application(f.fct, args)
            g.tpe = f.tpe
            return self.find(g) if self.contains(g) else g
        if isinstance(f, Binding):
            body = self.normalize(f.body)
            g = Binding(f.binder, f.vars, body)
            g.tpe = f.tpe
            return g
        return f

    def copy(self) -> "CongruenceClosure":
        out = CongruenceClosure()
        out._parent = dict(self._parent)
        out._proof = dict(self._proof)
        out._members = {k: list(v) for k, v in self._members.items()}
        out._sig = dict(self._sig)
        out._uses = {k: list(v) for k, v in self._uses.items()}
        return out

    # -- formula-level entry points ----------------------------------------

    def add_constraints(self, f: Formula) -> None:
        """Register ground equalities from a conjunction (ground subformulas
        only; quantified conjuncts contribute nothing)."""
        for c in get_conjuncts(f):
            if isinstance(c, Application) and c.fct == EQ:
                a, b = c.args
                try:
                    self.assert_eq(a, b)
                except ValueError:
                    pass  # non-ground equality: skip
            elif not isinstance(c, Binding):
                self._register_ground(c)

    def _register_ground(self, f: Formula) -> None:
        if isinstance(f, Binding):
            return
        if isinstance(f, Application):
            ok = all(not isinstance(x, Binding) for x in _subterms(f))
            if ok:
                self.add_term(f)


def _subterms(f: Formula):
    yield f
    if isinstance(f, Application):
        for a in f.args:
            yield from _subterms(a)
    elif isinstance(f, Binding):
        yield f.body


def euf_check(
    eqs: List[Tuple[Formula, Formula]],
    diseqs: List[Tuple[Formula, Formula]],
    extra_terms: Iterable[Formula] = (),
) -> Optional[Tuple[List[int], int]]:
    """EUF satisfiability of a conjunction of ground (dis)equalities.

    Returns None if consistent, else a conflict (indices into eqs, index into
    diseqs): a subset of the equalities which together with that disequality
    is inconsistent.  The subset is the exact proof-forest explanation —
    small in practice, though not guaranteed minimal.
    """
    cc = CongruenceClosure()
    for t in extra_terms:
        cc.add_term(t)
    for i, (a, b) in enumerate(eqs):
        cc.assert_eq(a, b, tag=i)
    for j, (a, b) in enumerate(diseqs):
        if cc.congruent(a, b):
            core = cc.explain(a, b)
            return sorted(core), j
    return None
