"""Quantifier-instantiation tracing: the instantiation graph as data + dumps.

Reference parity: psync.logic.quantifiers.QILogger (QILogger.scala:20-203) —
a node per instantiated clause with the ground terms it introduced, an edge
per (source clause → produced instance, instantiating term), dumped as
graphviz or vis.js for debugging why a proof needs depth k (enabled with
--logQI, VerificationOptions.scala:23).

Usage: pass a ``QILogger`` via ``quantifiers.instantiate(..., logger=...)``
(the CL reducer forwards ``ClConfig.qi_logger``); then ``store_graphviz`` /
``store_visjs`` or inspect ``nodes``/``edges`` directly.

Port of round_tpu/verify/qilog.py, copied with only the package name changed.
"""

from __future__ import annotations

import dataclasses
import html
from typing import Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.verify.formula import Formula


@dataclasses.dataclass
class Node:
    """One formula in the instantiation graph (QILogger.Node): a root
    ∀-clause or a produced instance, with the ground terms it introduced."""

    idx: int
    formula: Formula
    new_ground_terms: Tuple[Formula, ...] = ()
    round: int = 0
    is_root: bool = False  # a universal clause (vs a produced instance)
    phase: str = ""        # which reduce() pass produced it (ladder rung)


@dataclasses.dataclass(frozen=True)
class Edge:
    """src instantiated with `term` produced dst (QILogger.Edge)."""

    src: int
    dst: int
    term: str  # repr of the instantiating term(s); hashable for set-dedup


class QILogger:
    """Collects the instantiation graph (BasicQILogger semantics)."""

    def __init__(self):
        self.nodes: Dict[int, Node] = {}
        self.edges: List[Edge] = []
        self._edge_set: set = set()
        self._next = 0
        self.phase = ""

    def new_phase(self, label: str) -> None:
        """Mark the start of an independent reduction (one effort-ladder
        rung / decomposition branch); later nodes carry the label so the
        graph separates per pass instead of conflating them."""
        self.phase = label

    def reset(self) -> None:
        self.nodes.clear()
        self.edges.clear()
        self._edge_set.clear()
        self._next = 0

    def add_node(
        self,
        formula: Formula,
        new_ground_terms: Sequence[Formula] = (),
        round: int = 0,
        is_root: bool = False,
    ) -> int:
        idx = self._next
        self._next += 1
        self.nodes[idx] = Node(
            idx, formula, tuple(new_ground_terms), round, is_root, self.phase
        )
        return idx

    def add_edge(self, src: int, dst: int, term) -> None:
        assert src in self.nodes, f"source {src} does not exist"
        assert dst in self.nodes, f"destination {dst} does not exist"
        e = Edge(src, dst, repr(term))
        if e not in self._edge_set:
            self._edge_set.add(e)
            self.edges.append(e)

    # -- stats -------------------------------------------------------------

    def instantiations_of(self, idx: int) -> List[int]:
        return [e.dst for e in self.edges if e.src == idx]

    def summary(self) -> str:
        roots = [n for n in self.nodes.values() if n.is_root]
        per_key: Dict[Tuple[str, int], int] = {}
        for n in self.nodes.values():
            if not n.is_root:
                key = (n.phase, n.round)
                per_key[key] = per_key.get(key, 0) + 1
        rounds = ", ".join(
            (f"{ph} " if ph else "") + f"round {r}: {k} instances"
            for (ph, r), k in sorted(per_key.items())
        )
        return f"{len(roots)} clauses; {rounds or 'no instances'}"

    # -- dumps (printGraphviz / printVisJS) --------------------------------

    def to_graphviz(self) -> str:
        out = ["digraph QI {", "  node [shape=box fontsize=9];"]
        for n in self.nodes.values():
            label = html.escape(repr(n.formula)[:120])
            extra = ""
            if n.new_ground_terms:
                terms = html.escape(
                    ", ".join(repr(t)[:40] for t in n.new_ground_terms[:4])
                )
                extra = f"\\n+[{terms}]"
            out.append(f'  n{n.idx} [label="{label}{extra}"];')
        for e in self.edges:
            label = html.escape(e.term[:60])
            out.append(f'  n{e.src} -> n{e.dst} [label="{label}" fontsize=8];')
        out.append("}")
        return "\n".join(out)

    def to_visjs(self) -> str:
        import json

        nodes = [
            {"id": n.idx, "label": repr(n.formula)[:120], "round": n.round}
            for n in self.nodes.values()
        ]
        edges = [
            {"from": e.src, "to": e.dst, "label": e.term[:60]}
            for e in self.edges
        ]
        return (
            "var nodes = " + json.dumps(nodes) + ";\n"
            "var edges = " + json.dumps(edges) + ";\n"
        )

    def store_graphviz(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_graphviz())

    def store_visjs(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_visjs())
