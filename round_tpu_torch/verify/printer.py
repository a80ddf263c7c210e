"""Names + Printer: symbol/type mangling and formula pretty-printing.

Reference parity: psync.formula.Names (Names.scala:1-65 — SMT symbol
names, overloaded-symbol disambiguation by type suffix, type mangling)
and psync.formula.Printer (Printer.scala:1-169 — priority-aware printers:
MathML/HTML and TeX, plus conjunct tables).  The SMT-LIB2 emission itself
lives in verify/solver.py (to_smt2); this module is the presentation
layer: stable mangled names for external tools and human-readable
renderings for reports.

Port of round_tpu/verify/printer.py, copied with only the package name changed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from round_tpu_torch.verify.formula import (
    AND, Application, Binding, BoolT, CARD, COMPREHENSION, DIVIDES, EQ,
    EXISTS, FMap, FORALL, FOption, FSet, Formula, FunT, GEQ, GT, IMPLIES, IN,
    INTERSECTION, IntT, LEQ, LT, Literal, MINUS, NEQ, NOT, OR, PLUS, Product,
    SETMINUS, SUBSET_EQ, Symbol, TIMES, Type, UMINUS, UNION, UnInterpreted,
    UnInterpretedFct, Variable,
)

# ---------------------------------------------------------------------------
# Names (Names.scala): symbol + type mangling for external tools
# ---------------------------------------------------------------------------

_SMT_SYMBOL: Dict[Symbol, str] = {
    IMPLIES: "=>", OR: "or", AND: "and", NOT: "not", EQ: "=",
    GEQ: ">=", LEQ: "<=", GT: ">", LT: "<",
    PLUS: "+", MINUS: "-", UMINUS: "-", TIMES: "*", DIVIDES: "div",
    IN: "in", INTERSECTION: "intersection", UNION: "union",
    SETMINUS: "setminus", SUBSET_EQ: "subsetEq", CARD: "card",
}


def symbol(s: Symbol) -> str:
    """The SMT name of a symbol (Names.symbol).  ≠ must be rewritten to
    ¬(=) before emission, exactly as the reference insists."""
    if s == NEQ:
        raise ValueError("≠ should be replaced by Not(Eq(...)) (Names.scala)")
    if s in _SMT_SYMBOL:
        return _SMT_SYMBOL[s]
    return mangle(s.name)


def tpe(t: Type) -> str:
    """Type mangling (Names.tpe): structural types flatten to suffixable
    identifiers so overloaded symbols can be disambiguated by type."""
    if isinstance(t, BoolT):
        return "Bool"
    if isinstance(t, IntT):
        return "Int"
    if isinstance(t, FSet):
        return f"Set_{tpe(t.elem)}_"
    if isinstance(t, FOption):
        return f"Option_{tpe(t.elem)}_"
    if isinstance(t, FMap):
        return f"Map_{tpe(t.key)}_{tpe(t.value)}_"
    if isinstance(t, Product):
        return "Product" + "".join(f"_{tpe(a)}" for a in t.args) + "_"
    if isinstance(t, FunT):
        args = " ".join(f"({tpe(a)})" for a in t.args)
        return f"{args} ({tpe(t.ret)})"
    if isinstance(t, UnInterpreted):
        return t.name
    return repr(t).replace(" ", "")


def overloaded_symbol(s: Symbol, ts: Sequence[Type]) -> str:
    """Names.overloadedSymbol: disambiguate a polymorphic symbol by the
    argument types it is applied at (= stays overloaded; Int orders keep
    their plain name)."""
    if s == EQ:
        return "="
    if s in (LT, GT, LEQ, GEQ) and all(isinstance(t, IntT) for t in ts):
        return symbol(s)
    return symbol(s) + "".join(tpe(t) for t in ts)


def type_decl(t: Type) -> str:
    """Names.typeDecl: the (args) ret declaration shape of a function type."""
    if isinstance(t, FunT):
        args, ret = list(t.args), t.ret
    else:
        args, ret = [], t
    return "(" + " ".join(tpe(a) for a in args) + ") " + tpe(ret)


def mangle(name: str) -> str:
    """A legal SMT-LIB2 simple symbol for any internal name: the fresh-name
    punctuation (!, ', canonical suffixes) maps to underscores; a leading
    digit gets a prefix.  Injective on the generators' namespaces (the
    characters replaced never produce collisions with plain names, which
    never contain '_bang_')."""
    out = name.replace("!", "_bang_").replace("'", "_pr_").replace("|", "_bar_")
    if out and out[0].isdigit():
        out = "n_" + out
    return out


# ---------------------------------------------------------------------------
# Printers (Printer.scala): priority-aware rendering
# ---------------------------------------------------------------------------

_INFIX = {
    AND: ("∧", 40), OR: ("∨", 30), IMPLIES: ("→", 20),
    EQ: ("=", 50), NEQ: ("≠", 50),
    LEQ: ("≤", 50), LT: ("<", 50), GEQ: ("≥", 50), GT: (">", 50),
    PLUS: ("+", 60), MINUS: ("−", 60), TIMES: ("·", 70),
    DIVIDES: ("÷", 70), IN: ("∈", 50), SUBSET_EQ: ("⊆", 50),
    UNION: ("∪", 55), INTERSECTION: ("∩", 56), SETMINUS: ("∖", 55),
}


class PrettyPrinter:
    """Unicode pretty-printer with the reference's priority-aware
    parenthesization (Printer.printFormula's priority threading)."""

    quant = {FORALL: "∀", EXISTS: "∃"}
    true_, false_ = "⊤", "⊥"

    def __call__(self, f: Formula) -> str:
        return self._p(f, 0)

    def conjuncts_tbl(self, fs: Sequence[Formula]) -> str:
        """One conjunct per line (Printer.conjunctsTbl)."""
        return "\n".join(self._p(f, 0) for f in fs)

    # -- rendering hooks (overridden by the HTML/TeX subclasses) -----------
    def _lit(self, v) -> str:
        if v is True:
            return self.true_
        if v is False:
            return self.false_
        return str(v)

    def _var(self, name: str) -> str:
        return name

    def _wrap(self, s: str) -> str:
        return "(" + s + ")"

    def _p(self, f: Formula, prio: int) -> str:
        if isinstance(f, Literal):
            return self._lit(f.value)
        if isinstance(f, Variable):
            return self._var(f.name)
        if isinstance(f, Application):
            if f.fct == NOT:
                return "¬" + self._p(f.args[0], 90)
            if f.fct == UMINUS:
                return "−" + self._p(f.args[0], 90)
            if f.fct == CARD:
                return "|" + self._p(f.args[0], 0) + "|"
            if f.fct in _INFIX:
                op, op_prio = _INFIX[f.fct]
                inner = f" {op} ".join(self._p(a, op_prio) for a in f.args)
                return self._wrap(inner) if op_prio < prio else inner
            args = ", ".join(self._p(a, 0) for a in f.args)
            return f"{self._var(f.fct.name)}({args})"
        if isinstance(f, Binding):
            vs = ", ".join(self._var(v.name) for v in f.vars)
            if f.binder == COMPREHENSION:
                return "{ " + vs + " | " + self._p(f.body, 0) + " }"
            q = self.quant[f.binder]
            body = f"{q}{vs}. {self._p(f.body, 0)}"
            return self._wrap(body) if prio > 0 else body
        return repr(f)


class TexPrinter(PrettyPrinter):
    """LaTeX rendering (Printer.scala's TexPrinter role)."""

    quant = {FORALL: r"\forall ", EXISTS: r"\exists "}
    true_, false_ = r"\top", r"\bot"

    _TEX = {
        "∧": r"\land", "∨": r"\lor", "→": r"\implies", "≠": r"\neq",
        "≤": r"\leq", "≥": r"\geq", "·": r"\cdot", "÷": r"\div",
        "∈": r"\in", "⊆": r"\subseteq", "∪": r"\cup", "∩": r"\cap",
        "∖": r"\setminus", "−": "-", "¬": r"\neg ",
    }

    def _var(self, name: str) -> str:
        return name.replace("_", r"\_").replace("!", r"!\,")

    def __call__(self, f: Formula) -> str:
        s = super().__call__(f)
        for u, t in self._TEX.items():
            s = s.replace(u, t + " ")
        return s


class HtmlPrinter(PrettyPrinter):
    """MathML-ish HTML (HtmlPrinter, Printer.scala:27-80): identifiers in
    <mi>, numbers in <mn>, operators in <mo> — enough for the verifier's
    HTML report to embed formulas."""

    def _lit(self, v) -> str:
        if isinstance(v, bool):
            return f"<mi>{self.true_ if v else self.false_}</mi>"
        return f"<mn>{v}</mn>"

    def _var(self, name: str) -> str:
        import html as _html

        return f"<mi>{_html.escape(name)}</mi>"

    def _wrap(self, s: str) -> str:
        return "<mo>(</mo>" + s + "<mo>)</mo>"

    def __call__(self, f: Formula) -> str:
        s = self._p(f, 0)
        # operators not already tagged become <mo>
        for sym in list(_INFIX.values()):
            s = s.replace(f" {sym[0]} ", f"<mo>{sym[0]}</mo>")
        return f"<math>{s}</math>"


pretty = PrettyPrinter()
tex = TexPrinter()
html = HtmlPrinter()
