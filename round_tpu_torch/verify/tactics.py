"""Tactic-guided quantifier instantiation (reference:
logic/quantifiers/Tactic.scala:16-160 + IncrementalGenerator.scala:15-60).

A Tactic owns a priority queue of candidate ground TERMS ordered by
generation depth: seed terms start at depth 0, terms discovered inside
instantiation results enter at depth+1, and a per-term depth bound decides
what ever enters the queue — `Eager` bounds by type (Tactic.scala:96-102),
`ByName` by symbol-name prefix (:105-131), `Sequence` chains tactics
(:144-160).  The driver (instantiate_tactic) pops terms one at a time and
extends partial substitutions of each ∀-clause with the popped term — the
IncrementalGenerator discipline: instantiation is *term-driven* (only
terms the tactic released can ever appear in an instance), unlike the
whole-product eager strategy (quantifiers.instantiate) or trigger matching
(matching.instantiate_matching).

Wire a tactic into CL reduction with ClConfig(tactic=...): it then replaces
the strategy-selected round-1 instantiation (QStrategy's tactic slot,
ClConfig.scala:20-24).

Port of round_tpu/verify/tactics.py, copied with only the package name changed.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, Iterable, List, Optional, Sequence as Seq, Tuple

from round_tpu_torch.verify.congruence import CongruenceClosure
from round_tpu_torch.verify.formula import (
    Application, Binding, BoolT, Formula, Type, Variable,
)
from round_tpu_torch.verify.futils import collect_ground_terms, subst_vars


class Tactic:
    """Order and bound the ground terms fed to the instantiation driver."""

    def init(self, cc: CongruenceClosure, seeds: Iterable[Formula]) -> None:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> Formula:
        raise NotImplementedError

    def generator_result(self, fs: Iterable[Formula]) -> None:
        """Feed instantiation results back: their new ground terms become
        candidates at depth + 1."""
        raise NotImplementedError


class _TacticCommon(Tactic):
    """The queue/dedup/depth machinery shared by Eager and ByName
    (TacticCommon, Tactic.scala:32-94).  Subclasses supply depth_of(term):
    the maximum generation depth at which the term may still enter."""

    def __init__(self):
        self._heap: List[Tuple[int, int, Formula]] = []
        self._tie = itertools.count()
        self._done: set = set()
        self._depth = 0
        self._cc: Optional[CongruenceClosure] = None

    def depth_of(self, t: Formula) -> int:
        raise NotImplementedError

    def _is_done(self, t: Formula) -> bool:
        return t in self._done or self._cc.repr_of(t) in self._done

    def _enqueue(self, d: int, t: Formula) -> None:
        # untyped/boolean terms (bare Eq/Geq applications) can never fill a
        # typed variable slot; keep them out of the queue
        if t.tpe is None or isinstance(t.tpe, BoolT):
            return
        if d < self.depth_of(t) and not self._is_done(t):
            heapq.heappush(self._heap, (d, next(self._tie), t))

    def init(self, cc: CongruenceClosure, seeds: Iterable[Formula]) -> None:
        self._heap, self._done, self._depth = [], set(), 0
        self._cc = cc
        for t in seeds:
            self._enqueue(0, t)

    def has_next(self) -> bool:
        while self._heap:
            _d, _k, t = self._heap[0]
            if self._is_done(t):
                heapq.heappop(self._heap)
                continue
            return True
        return False

    def next(self) -> Formula:
        d, _k, t = heapq.heappop(self._heap)
        self._depth = d
        self._done.add(t)
        self._done.add(self._cc.repr_of(t))
        return t

    def generator_result(self, fs: Iterable[Formula]) -> None:
        nd = self._depth + 1
        for f in fs:
            # snapshot freshness BEFORE enqueuing anything: _enqueue's
            # done-check registers terms (and their subterms) into the
            # congruence closure, which would make a sibling subterm look
            # stale depending on set-iteration order
            fresh = [t for t in collect_ground_terms(f)
                     if not self._cc.contains(t)]
            for t in fresh:
                self._enqueue(nd, t)
        for f in fs:
            self._cc.add_constraints(f)


class Eager(_TacticCommon):
    """Depth bound per TYPE (Eager, Tactic.scala:96-102): Eager(2) allows
    every term two generations; Eager({procType: 1}, default=0) releases
    only process terms, one generation deep."""

    def __init__(self, depth=1, default: Optional[int] = None):
        super().__init__()
        if isinstance(depth, int):
            self._by_type: Dict[Type, int] = {}
            self._default = depth
        else:
            self._by_type = dict(depth)
            self._default = depth.get("default", 0) if default is None \
                else default

    def depth_of(self, t: Formula) -> int:
        return self._by_type.get(t.tpe, self._default)

    def __repr__(self):
        return f"Eager({self._by_type or self._default})"


class ByName(_TacticCommon):
    """Depth bound per head-symbol/variable NAME prefix (ByName,
    Tactic.scala:105-131); unknown names default to 0 (never released)."""

    def __init__(self, depth: Dict[str, int], default: int = 0):
        super().__init__()
        self._by_name = dict(depth)
        self._default = default

    @staticmethod
    def name_of(t: Formula) -> str:
        if isinstance(t, Variable):
            return t.name.split("!")[0]
        if isinstance(t, Application):
            return getattr(t.fct, "name", str(t.fct)).split("!")[0]
        return "__no_name__"

    def depth_of(self, t: Formula) -> int:
        return self._by_name.get(self.name_of(t), self._default)

    def __repr__(self):
        return f"ByName({self._by_name})"


class Sequence(Tactic):
    """Run tactics in order; each starts from the congruence state the
    previous one left behind (Sequence, Tactic.scala:144-160)."""

    def __init__(self, *tactics: Tactic):
        self._tactics = list(tactics)
        self._idx = 0
        self._cc: Optional[CongruenceClosure] = None
        self._seeds: List[Formula] = []

    def init(self, cc: CongruenceClosure, seeds: Iterable[Formula]) -> None:
        self._idx = 0
        self._cc = cc
        self._seeds = list(seeds)
        if self._tactics:
            self._tactics[0].init(cc, self._seeds)

    def has_next(self) -> bool:
        while self._idx < len(self._tactics):
            if self._tactics[self._idx].has_next():
                return True
            self._idx += 1
            if self._idx < len(self._tactics):
                # re-seed the next tactic over the grown term universe
                self._tactics[self._idx].init(
                    self._cc, self._cc.ground_terms()
                )
        return False

    def next(self) -> Formula:
        return self._tactics[self._idx].next()

    def generator_result(self, fs: Iterable[Formula]) -> None:
        self._tactics[self._idx].generator_result(fs)


# ---------------------------------------------------------------------------
# The incremental, term-driven driver
# ---------------------------------------------------------------------------

def instantiate_tactic(
    universals: Seq[Binding],
    ground: Seq[Formula],
    tactic: Tactic,
    max_insts: int = 50_000,
    logger=None,
    logger_base_round: int = 0,
) -> List[Formula]:
    """IncrementalGenerator.saturate (IncrementalGenerator.scala:15-60):
    pop tactic-released terms one at a time; each term extends every
    compatible partial substitution of every ∀-clause by one variable;
    completed substitutions emit instances, which feed back into the
    tactic (new ground terms at depth + 1).  Same driver contract as
    quantifiers.instantiate (dedup modulo congruence, QILogger hooks)."""
    cc = CongruenceClosure()
    for g in ground:
        cc.add_constraints(g)
    seeds: List[Formula] = []
    seen_seed: set = set()
    for f in list(ground) + list(universals):
        for t in collect_ground_terms(f):
            if t not in seen_seed:
                seen_seed.add(t)
                seeds.append(t)
    tactic.init(cc, seeds)

    roots: dict = {}
    if logger is not None:
        for u in universals:
            roots[id(u)] = logger.add_node(
                u, round=logger_base_round, is_root=True
            )

    # instantiation is restricted to terms the tactic has RELEASED: on each
    # new term t, emit every substitution over released terms that uses t
    # in at least one position (so each combo is generated exactly once,
    # when its last-released term arrives)
    released_by_type: Dict[Type, List[Formula]] = {}
    released_set: set = set()
    produced: List[Formula] = []
    seen_inst: set = set()
    released = 0
    while tactic.has_next() and len(seen_inst) <= max_insts:
        term = tactic.next()
        if term in released_set:
            # a Sequence successor re-seeds over the grown universe and
            # re-releases prior terms; duplicates would multiply the
            # candidate products for nothing
            continue
        released_set.add(term)
        released += 1
        released_by_type.setdefault(term.tpe, []).append(term)
        new_formulas: List[Formula] = []
        for u in universals:
            pin_positions = [v for v in u.vars if v.tpe == term.tpe]
            if not pin_positions:
                continue
            for pin in pin_positions:
                cands = []
                for v in u.vars:
                    if v is pin:
                        cands.append([term])
                    else:
                        cands.append(released_by_type.get(v.tpe, []))
                if any(not c for c in cands):
                    continue
                for combo in itertools.product(*cands):
                    key = (id(u), tuple(cc.repr_of(t) for t in combo))
                    if key in seen_inst:
                        continue
                    seen_inst.add(key)
                    inst = subst_vars(u.body, dict(zip(u.vars, combo)))
                    new_formulas.append(inst)
                    if logger is not None:
                        dst = logger.add_node(
                            inst, new_ground_terms=combo,
                            round=logger_base_round + released,
                        )
                        logger.add_edge(roots[id(u)], dst, combo)
                    if len(seen_inst) > max_insts:
                        break
                if len(seen_inst) > max_insts:
                    break
        produced.extend(new_formulas)
        if new_formulas:
            tactic.generator_result(new_formulas)
    return produced
