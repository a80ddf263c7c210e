"""runtimelint rule implementations: the five runtime families.

Port of round_tpu/analysis/runtimerules.py: the passes are round_tpu's
(AST, regex and small-domain evaluation); the declared registries at the
bottom name the port's files, and the fold pass evaluates the port's
kv.store folds with torch.

roundlint gates the MODEL layer; these passes gate the serving runtime —
the tier where the worst hand-caught bugs lived (the pump-disarm race,
the 2PC vote mis-routing, the seq-LWW fold divergence).  Each family
turns one of those bug classes into a rule:

  lock-discipline     mixed locked/unlocked writes to shared driver
                      fields, lock-order inversions, and writes to
                      pump-registered mailbox buffers on paths where the
                      lane is not provably disarmed (the oob-adoption fix).
  wire-coherence      FLAG_*/tag constants pinned across the Python /
                      C++ wire boundary, plus static DISPATCH TOTALITY:
                      every flag handled (or explicitly routed to
                      fallback) on every declared receive surface.
  fold-determinism    SMR apply folds discharged commutative + totally
                      tie-ordered by small-domain exhaustive evaluation,
                      with refusal semantics when a fold cannot be
                      evaluated.
  counter-accounting  every metrics/trace emission site resolves to a
                      declared name; paired counters that must balance
                      have both sides' tick sites present.
  obs-vocab           the emitted counter/event vocabulary diffed
                      against round_tpu_torch/docs/OBSERVABILITY.md in
                      both directions.

All passes are CPU-only and STATIC (AST / regex / small-domain eval) —
nothing here imports or executes the code under analysis except the fold
pass, which evaluates registered fold callables on tiny closed domains.

The declared registries a shipped tree is checked against (surfaces,
flag routes, counter pairs, dynamic-name sites, fold specs) live at the
bottom of this module; ``runtimelint.default_config()`` assembles them.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, \
    Tuple

from round_tpu_torch.analysis.findings import Finding, relpath

# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def repo_path(*parts: str) -> str:
    return os.path.join(_REPO, *parts)


def _model_for(path: str) -> str:
    """The Finding.model slot for a runtime finding: the subsystem that
    owns the file (``runtime``, ``kv``, ``native``, ``docs``, ...)."""
    rel = relpath(path)
    parts = rel.split(os.sep)
    if parts[0] == "round_tpu_torch" and len(parts) > 2:
        return parts[1]
    if parts[0] in ("docs", "tools", "tests"):
        return parts[0]
    return parts[0]


def _read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _parse(path: str) -> ast.Module:
    return ast.parse(_read(path), filename=path)


def _is_self_attr(node: ast.AST, name: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"
            and (name is None or node.attr == name))


def _self_attr_root(node: ast.AST) -> Optional[str]:
    """The self-attribute a write/call chain is rooted at:
    ``self._boxes[c].insert`` -> ``_boxes``; None when not self-rooted."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if _is_self_attr(node):
            return node.attr
        node = node.value
    return None


def _funcs_of(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Every function in a module by dotted qualname (classes and nested
    defs flatten into the path: ``HostRunner.run.ingest``)."""
    out: Dict[str, ast.FunctionDef] = {}

    def walk(node: ast.AST, qual: str) -> None:
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                q = f"{qual}.{ch.name}" if qual else ch.name
                if not isinstance(ch, ast.ClassDef):
                    out[q] = ch
                walk(ch, q)
            else:
                walk(ch, qual)

    walk(tree, "")
    return out


# ---------------------------------------------------------------------------
# family 1: lock-discipline
# ---------------------------------------------------------------------------

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                         "BoundedSemaphore"})
#: container mutations that count as writes through a guarded field
_MUTATORS = frozenset({"append", "appendleft", "add", "insert", "extend",
                       "update", "setdefault", "pop", "popleft", "popitem",
                       "remove", "discard", "clear", "put", "put_nowait"})
#: the repo's "caller holds <lock>" convention: a method whose source
#: (docstring or comment) states the caller's lock is treated as holding
#: that lock for its whole body
_CALLER_HOLDS_RE = re.compile(r"caller holds\s+`?([A-Za-z_]\w*)`?")
#: sentinel lockset for `_locked`-suffixed helpers: some caller lock is
#: held, identity unknown — counts as guarded, never orders
_CALLER_LOCK = "<caller-lock>"


@dataclasses.dataclass
class _WriteSite:
    attr: str
    method: str
    line: int
    held: FrozenSet[str]


class _LockWalker:
    """One class body: per-statement lock scopes, write sites, and the
    (outer, inner) acquisition-order pairs."""

    def __init__(self, cls: ast.ClassDef, src_lines: List[str]):
        self.cls = cls
        self.src_lines = src_lines
        self.lock_attrs: Dict[str, int] = {}
        self.writes: List[_WriteSite] = []
        self.order: Dict[Tuple[str, str], int] = {}
        self._collect_locks()

    def _collect_locks(self) -> None:
        for node in ast.walk(self.cls):
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            ctor = None
            if isinstance(v, ast.Call):
                f = v.func
                if isinstance(f, ast.Attribute) and f.attr in _LOCK_CTORS:
                    ctor = f.attr
                elif isinstance(f, ast.Name) and f.id in _LOCK_CTORS:
                    ctor = f.id
            if ctor is None:
                continue
            for t in node.targets:
                if _is_self_attr(t):
                    self.lock_attrs.setdefault(t.attr, node.lineno)

    # -- per-method walk ---------------------------------------------------

    def _method_base_held(self, fn: ast.FunctionDef) -> FrozenSet[str]:
        held = set()
        if fn.name.endswith("_locked"):
            held.add(_CALLER_LOCK)
        seg = "\n".join(self.src_lines[fn.lineno - 1:fn.end_lineno])
        for m in _CALLER_HOLDS_RE.finditer(seg):
            name = m.group(1)
            held.add(name if name in self.lock_attrs else _CALLER_LOCK)
        return frozenset(held)

    def walk_method(self, fn: ast.FunctionDef) -> None:
        self._method = fn.name
        self._block(fn.body, self._method_base_held(fn))

    def _acquire(self, held: FrozenSet[str], lock: str,
                 line: int) -> FrozenSet[str]:
        for h in held:
            if h != _CALLER_LOCK and h != lock:
                self.order.setdefault((h, lock), line)
        return held | {lock}

    def _block(self, stmts: Sequence[ast.stmt],
               held: FrozenSet[str]) -> None:
        for st in stmts:
            held = self._stmt(st, held)

    def _stmt(self, st: ast.stmt, held: FrozenSet[str]) -> FrozenSet[str]:
        if isinstance(st, (ast.With, ast.AsyncWith)):
            inner = held
            for item in st.items:
                ce = item.context_expr
                if _is_self_attr(ce) and ce.attr in self.lock_attrs:
                    inner = self._acquire(inner, ce.attr, st.lineno)
                else:
                    self._exprs(ce, held)
            self._block(st.body, inner)
            return held
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            f = st.value.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in ("acquire", "release")
                    and _is_self_attr(f.value)
                    and f.value.attr in self.lock_attrs):
                lk = f.value.attr
                if f.attr == "acquire":
                    return self._acquire(held, lk, st.lineno)
                return held - {lk}
            self._exprs(st.value, held)
            return held
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (st.targets if isinstance(st, ast.Assign)
                       else [st.target])
            for t in targets:
                root = _self_attr_root(t)
                if root is not None:
                    self.writes.append(_WriteSite(root, self._method,
                                                  st.lineno, held))
            val = getattr(st, "value", None)
            if val is not None:
                self._exprs(val, held)
            return held
        if isinstance(st, ast.Delete):
            for t in st.targets:
                root = _self_attr_root(t)
                if root is not None:
                    self.writes.append(_WriteSite(root, self._method,
                                                  st.lineno, held))
            return held
        # compound statements: visit sub-blocks under the same lockset
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(st, field, None)
            if sub:
                self._block(sub, held)
        for h in getattr(st, "handlers", []) or []:
            self._block(h.body, held)
        for attr in ("test", "iter", "value"):
            sub = getattr(st, attr, None)
            if isinstance(sub, ast.expr):
                self._exprs(sub, held)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def (worker-thread body): its writes are real
            # sites, but only the locks IT takes are provably held
            saved = self._method
            self._method = f"{saved}.{st.name}"
            self._block(st.body, self._method_base_held(st))
            self._method = saved
        return held

    def _exprs(self, e: ast.expr, held: FrozenSet[str]) -> None:
        """Mutating calls inside expressions: self.X[...].append(...)."""
        for node in ast.walk(e):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                root = _self_attr_root(f.value)
                if root is not None:
                    self.writes.append(_WriteSite(root, self._method,
                                                  node.lineno, held))


def lock_discipline(py_file: str) -> List[Finding]:
    """Mixed locked/unlocked writes + lock-order inversions, per class."""
    out: List[Finding] = []
    tree = _parse(py_file)
    src_lines = _read(py_file).splitlines()
    rel, model = relpath(py_file), _model_for(py_file)
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        w = _LockWalker(cls, src_lines)
        if not w.lock_attrs:
            continue
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w.walk_method(fn)
        by_attr: Dict[str, List[_WriteSite]] = {}
        for s in w.writes:
            if s.method.split(".")[0] in ("__init__", "__post_init__"):
                continue  # construction is single-threaded by contract
            if s.attr in w.lock_attrs:
                continue  # rebinding the lock object itself is not data
            by_attr.setdefault(s.attr, []).append(s)
        for attr, sites in sorted(by_attr.items()):
            locked = [s for s in sites if s.held]
            bare = [s for s in sites if not s.held]
            if locked and bare:
                lk = sorted(locked[0].held)[0]
                b = bare[0]
                out.append(Finding(
                    rule="lock-discipline/mixed-guard", severity="error",
                    model=model, file=rel, line=b.line,
                    message=(f"{cls.name}.{b.method} writes self.{attr} "
                             f"with no lock held, but "
                             f"{cls.name}.{locked[0].method} (line "
                             f"{locked[0].line}) guards the same field "
                             f"with {lk}"),
                    hint=("take the same lock, or state the convention "
                          "with a 'caller holds <lock>' comment"),
                ))
        for (a, b), line in sorted(w.order.items()):
            if (b, a) in w.order and a < b:
                out.append(Finding(
                    rule="lock-discipline/order-inversion", severity="error",
                    model=model, file=rel,
                    line=max(line, w.order[(b, a)]),
                    message=(f"{cls.name} acquires {a} then {b} (line "
                             f"{line}) but also {b} then {a} (line "
                             f"{w.order[(b, a)]}) — deadlock-capable "
                             f"order inversion"),
                    hint="pick one global order for the two locks",
                ))
    return out


# -- pump discipline: writes to pump-registered mailbox buffers ------------


@dataclasses.dataclass(frozen=True)
class PumpSpec:
    """One pump-owning class: which buffer fields the native pump holds
    BY POINTER, and what counts as proof the lane is disarmed before a
    Python-side write (round_tpu's oob-adoption fix as a rule)."""

    file: str
    class_name: str
    pump_attr: str = "_pump"
    buffer_attrs: Tuple[str, ...] = ("_boxes",)
    mutators: Tuple[str, ...] = ("insert", "clear", "fill", "reset", "set",
                                 "adopt", "append", "add")
    disarm_names: Tuple[str, ...] = ("disarm", "disarm_all", "disable")


def _terminates(block: Sequence[ast.stmt]) -> bool:
    return bool(block) and isinstance(
        block[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


class _PumpWalker:
    """Sequential walk of one method: tracks whether the pump lane is
    provably quiet (disarm seen earlier, or inside an `if pump is None`
    branch) at each buffer mutation."""

    def __init__(self, spec: PumpSpec):
        self.spec = spec
        self.hits: List[Tuple[int, str]] = []

    def walk(self, fn: ast.FunctionDef) -> None:
        self._method = fn.name
        self._block(fn.body, False)

    def _pump_test(self, test: ast.expr) -> Optional[str]:
        """'none' when the test proves self.<pump> is None in the body,
        'some' when it proves it is live, None otherwise."""
        sp = self.spec
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            l, op, r = test.left, test.ops[0], test.comparators[0]
            pair = ((l, r) if _is_self_attr(l, sp.pump_attr) else
                    (r, l) if _is_self_attr(r, sp.pump_attr) else None)
            if pair and isinstance(pair[1], ast.Constant) \
                    and pair[1].value is None:
                if isinstance(op, (ast.Is, ast.Eq)):
                    return "none"
                if isinstance(op, (ast.IsNot, ast.NotEq)):
                    return "some"
        if _is_self_attr(test, sp.pump_attr):
            return "some"
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and _is_self_attr(test.operand, sp.pump_attr):
            return "none"
        return None

    def _is_disarm(self, node: ast.Call) -> bool:
        f = node.func
        return isinstance(f, ast.Attribute) and f.attr in \
            self.spec.disarm_names

    def _mutation(self, node: ast.AST) -> Optional[int]:
        sp = self.spec
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in sp.mutators:
                if _self_attr_root(f.value) in sp.buffer_attrs:
                    return node.lineno
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)) \
                        and _self_attr_root(t) in sp.buffer_attrs \
                        and not _is_self_attr(t):
                    return node.lineno
        return None

    def _block(self, stmts: Sequence[ast.stmt], quiet: bool) -> bool:
        for st in stmts:
            quiet = self._stmt(st, quiet)
        return quiet

    def _stmt(self, st: ast.stmt, quiet: bool) -> bool:
        line = self._mutation(st)
        if line is None:
            for node in ast.walk(st) if not isinstance(
                    st, (ast.If, ast.For, ast.While, ast.Try, ast.With,
                         ast.FunctionDef, ast.AsyncFunctionDef)) else []:
                if isinstance(node, ast.Call):
                    m = self._mutation(node)
                    if m is not None:
                        line = m
                        break
                    if self._is_disarm(node):
                        quiet = True
        if line is not None and not quiet:
            self.hits.append((line, self._method))
        if isinstance(st, ast.If):
            verdict = self._pump_test(st.test)
            q_body = self._block(st.body,
                                 True if verdict == "none" else quiet)
            q_else = self._block(st.orelse,
                                 True if verdict == "some" else quiet)
            if verdict == "some" and _terminates(st.body) \
                    and not st.orelse:
                # `if pump is not None: ...; return` — the continuation
                # only runs with no pump armed (the _ingest idiom)
                return True
            if st.orelse:
                return quiet or (q_body and q_else)
            return quiet
        if isinstance(st, (ast.For, ast.While, ast.With, ast.AsyncWith)):
            self._block(st.body, quiet)
            return quiet
        if isinstance(st, ast.Try):
            q = self._block(st.body, quiet)
            for h in st.handlers:
                self._block(h.body, quiet)
            self._block(st.orelse, q)
            self._block(st.finalbody, quiet)
            return quiet
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            saved = self._method
            self._method = f"{saved}.{st.name}"
            self._block(st.body, False)
            self._method = saved
            return quiet
        return quiet


def pump_discipline(spec: PumpSpec) -> List[Finding]:
    out: List[Finding] = []
    tree = _parse(spec.file)
    rel, model = relpath(spec.file), _model_for(spec.file)
    cls = next((n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)
                and n.name == spec.class_name), None)
    if cls is None:
        return [Finding(
            rule="lock-discipline/pump-write-no-disarm", severity="error",
            model=model, file=rel, line=1,
            message=(f"pump spec names class {spec.class_name} which does "
                     f"not exist in {rel} — registry rot"),
            hint="update PUMP_SPECS in analysis/runtimerules.py")]
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in ("__init__", "__post_init__"):
            continue  # pump not armed yet during construction
        w = _PumpWalker(spec)
        w.walk(fn)
        for line, method in w.hits:
            out.append(Finding(
                rule="lock-discipline/pump-write-no-disarm",
                severity="error", model=model, file=rel, line=line,
                message=(f"{spec.class_name}.{method} mutates pump-"
                         f"registered buffer "
                         f"({'/'.join(spec.buffer_attrs)}) with no "
                         f"preceding {spec.pump_attr} disarm and no "
                         f"`{spec.pump_attr} is None` guard — the native "
                         f"pump holds this array by pointer and may be "
                         f"writing it concurrently"),
                hint=(f"disarm the lane first (self.{spec.pump_attr}"
                      f".disarm(...)), or guard the write with "
                      f"`if self.{spec.pump_attr} is None`"),
            ))
    return out


# ---------------------------------------------------------------------------
# family 2: wire-coherence
# ---------------------------------------------------------------------------

_CPP_CONST_RE = re.compile(
    r"constexpr\s+[\w:<>\s]+?\bk([A-Z]\w*)\s*=\s*(0x[0-9a-fA-F]+|\d+)")


def _camel_to_upper_snake(s: str) -> str:
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", s).upper()


def _py_int_consts(path: str, prefix: str) -> Dict[str, Tuple[int, int]]:
    """Module-level ``PREFIX_X = <int>`` constants: name -> (value, line)."""
    out: Dict[str, Tuple[int, int]] = {}
    for node in _parse(path).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith(prefix) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            out[node.targets[0].id] = (node.value.value, node.lineno)
    return out


def _cpp_consts(path: str) -> Dict[str, Tuple[int, int]]:
    out: Dict[str, Tuple[int, int]] = {}
    src = _read(path)
    for m in _CPP_CONST_RE.finditer(src):
        line = src.count("\n", 0, m.start()) + 1
        out["k" + m.group(1)] = (int(m.group(2), 0), line)
    return out


@dataclasses.dataclass(frozen=True)
class CppPin:
    """One structural property the C++ receive path must keep: a regex
    that must match transport.cpp, and what its absence means."""

    pattern: str
    message: str
    hint: str = ""


#: the native receive path's non-negotiables: the non-NORMAL fallback
#: route (everything the fast path does not own goes to the Python
#: inbox/misc drain — silent drop of an unknown flag is the bug class)
#: and the container splitter keyed on the batch flag.
DEFAULT_CPP_PINS = (
    CppPin(r"!=\s*kFlagNormal\s*\)\s*return 0",
           "the route fast path no longer routes non-NORMAL flags to the "
           "fallback inbox (`!= kFlagNormal) return 0` not found) — an "
           "unknown flag would be consumed silently",
           "keep the explicit non-NORMAL -> inbox/misc fallback"),
    CppPin(r"==\s*kFlagBatch",
           "the receive path no longer splits on kFlagBatch — container "
           "frames would be delivered unsplit",
           "keep the kFlagBatch container splitter"),
)


def wire_constants(cpp_file: str, flags_file: str,
                   codec_file: Optional[str] = None,
                   pins: Sequence[CppPin] = DEFAULT_CPP_PINS
                   ) -> List[Finding]:
    """Pin C++ kFlag* constants against Python FLAG_*; flag duplicate
    values inside each vocabulary; assert the native fallback pins."""
    out: List[Finding] = []
    cpp_rel, cpp_model = relpath(cpp_file), _model_for(cpp_file)
    flags = _py_int_consts(flags_file, "FLAG_")
    flags_rel = relpath(flags_file)

    for cname, (cval, cline) in sorted(_cpp_consts(cpp_file).items()):
        if not cname.startswith("kFlag"):
            continue
        pyname = "FLAG_" + _camel_to_upper_snake(cname[len("kFlag"):])
        if pyname not in flags:
            out.append(Finding(
                rule="wire-coherence/constant-mismatch", severity="error",
                model=cpp_model, file=cpp_rel, line=cline,
                message=(f"{cname} has no Python counterpart {pyname} in "
                         f"{flags_rel} — one side of the wire renamed or "
                         f"dropped a flag"),
                hint="keep kFlag* and FLAG_* name-for-name in sync"))
        elif flags[pyname][0] != cval:
            out.append(Finding(
                rule="wire-coherence/constant-mismatch", severity="error",
                model=cpp_model, file=cpp_rel, line=cline,
                message=(f"{cname} = {cval:#x} but {flags_rel} "
                         f"{pyname} = {flags[pyname][0]:#x} — the two "
                         f"sides of the wire disagree on the flag byte"),
                hint="fix whichever side drifted; bytes on the wire win"))

    for path, prefix in [(flags_file, "FLAG_")] + (
            [(codec_file, "T_")] if codec_file else []):
        consts = _py_int_consts(path, prefix)
        seen: Dict[int, str] = {}
        for name, (val, line) in sorted(consts.items(),
                                        key=lambda kv: kv[1][1]):
            if val in seen:
                out.append(Finding(
                    rule="wire-coherence/constant-clash", severity="error",
                    model=_model_for(path), file=relpath(path), line=line,
                    message=(f"{name} = {val:#x} collides with "
                             f"{seen[val]} — two wire constants share one "
                             f"byte, dispatch is ambiguous"),
                    hint="allocate a fresh byte (see the oob.py ledger)"))
            else:
                seen[val] = name

    src = _read(cpp_file)
    for pin in pins:
        if not re.search(pin.pattern, src):
            out.append(Finding(
                rule="wire-coherence/native-fallback", severity="error",
                model=cpp_model, file=cpp_rel, line=1,
                message=pin.message, hint=pin.hint))
    return out


@dataclasses.dataclass(frozen=True)
class SurfaceSpec:
    """One receive surface: a function that dispatches on tag flags, and
    the flags it is REQUIRED to handle.  The pass checks the declaration
    both ways: a declared flag the code no longer compares against is a
    dispatch gap; a compared flag the registry does not declare is
    registry rot."""

    name: str
    file: str
    qualname: str
    handles: FrozenSet[str]


def _compared_flags(fn: ast.FunctionDef, prefix: str = "FLAG_"
                    ) -> FrozenSet[str]:
    """Flag names appearing in comparison positions (==, !=, in, not in)
    anywhere in the function.  Names used only to CONSTRUCT tags (reply
    sends) do not count as dispatch."""
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        for sub in [node.left] + list(node.comparators):
            for n in ast.walk(sub):
                if isinstance(n, ast.Name) and n.id.startswith(prefix):
                    out.add(n.id)
                elif isinstance(n, ast.Attribute) \
                        and n.attr.startswith(prefix):
                    out.add(n.attr)
    return frozenset(out)


def dispatch_totality(surfaces: Sequence[SurfaceSpec], flags_file: str,
                      non_dispatch: Dict[str, str]) -> List[Finding]:
    """Static dispatch totality over the declared receive surfaces plus
    the global check: every FLAG_* in the vocabulary is handled
    somewhere or explicitly declared non-dispatched (with a reason)."""
    out: List[Finding] = []
    vocab = _py_int_consts(flags_file, "FLAG_")
    flags_rel = relpath(flags_file)
    declared_union: set = set()
    trees: Dict[str, Dict[str, ast.FunctionDef]] = {}

    for s in surfaces:
        declared_union |= set(s.handles)
        rel, model = relpath(s.file), _model_for(s.file)
        if s.file not in trees:
            try:
                trees[s.file] = _funcs_of(_parse(s.file))
            except (OSError, SyntaxError) as e:
                out.append(Finding(
                    rule="wire-coherence/dispatch-gap", severity="error",
                    model=model, file=rel, line=1,
                    message=f"surface {s.name}: cannot parse {rel}: {e}",
                    hint="fix the file or the surface registry"))
                trees[s.file] = {}
        fn = trees[s.file].get(s.qualname)
        if fn is None:
            out.append(Finding(
                rule="wire-coherence/dispatch-gap", severity="error",
                model=model, file=rel, line=1,
                message=(f"surface {s.name}: function {s.qualname} not "
                         f"found in {rel} — the receive surface moved; "
                         f"the registry must follow"),
                hint="update SURFACES in analysis/runtimerules.py"))
            continue
        compared = _compared_flags(fn)
        for missing in sorted(set(s.handles) - compared):
            out.append(Finding(
                rule="wire-coherence/dispatch-gap", severity="error",
                model=model, file=rel, line=fn.lineno,
                message=(f"surface {s.name} ({s.qualname}) no longer "
                         f"dispatches {missing} — frames with that flag "
                         f"fall through undetected"),
                hint="restore the branch or update the surface registry"))
        for extra in sorted(compared - set(s.handles)):
            out.append(Finding(
                rule="wire-coherence/undeclared-dispatch", severity="warn",
                model=model, file=rel, line=fn.lineno,
                message=(f"surface {s.name} ({s.qualname}) dispatches on "
                         f"{extra} which the surface registry does not "
                         f"declare"),
                hint=(f"add {extra} to the surface's handles in "
                      f"analysis/runtimerules.py")))
        for ghost in sorted(set(s.handles) - set(vocab)):
            out.append(Finding(
                rule="wire-coherence/dispatch-gap", severity="error",
                model=model, file=rel, line=fn.lineno,
                message=(f"surface {s.name} declares {ghost} which is not "
                         f"a {flags_rel} constant — stale registry"),
                hint="remove the stale flag from the surface registry"))

    for fname, (_val, line) in sorted(vocab.items(),
                                      key=lambda kv: kv[1][1]):
        if fname not in declared_union and fname not in non_dispatch:
            out.append(Finding(
                rule="wire-coherence/dispatch-gap", severity="error",
                model=_model_for(flags_file), file=flags_rel, line=line,
                message=(f"{fname} is in the wire vocabulary but no "
                         f"declared receive surface handles it and it is "
                         f"not registered non-dispatch — frames with this "
                         f"flag would be dropped on the floor"),
                hint=("route it on a surface, or add it to NON_DISPATCH "
                      "with the reason it never needs a branch")))
    for fname in sorted(non_dispatch):
        if fname in vocab and fname in declared_union:
            out.append(Finding(
                rule="wire-coherence/dispatch-gap", severity="error",
                model=_model_for(flags_file), file=flags_rel,
                line=vocab[fname][1],
                message=(f"{fname} is declared non-dispatch "
                         f"({non_dispatch[fname]!r}) but a surface also "
                         f"declares handling it — pick one"),
                hint="drop it from NON_DISPATCH or from the surface"))
    return out


# ---------------------------------------------------------------------------
# family 3: fold-determinism
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FoldSpec:
    """One SMR apply fold and the small closed domain its obligations are
    discharged on.  ``build()`` returns a dict with:

      apply(state, rec) -> state   the fold (must not mutate its inputs)
      records: list                the record domain
      starts: list                 starting states
      eq(s1, s2) -> bool           state equality
      describe(rec) -> str         witness rendering
      trace() -> None (optional)   traceability probe (make_fx);
                                   raising means the fold left the
                                   traced world

    Build or evaluation failure is a REFUSAL, not a pass: the rule emits
    fold-determinism/refused so un-analyzable folds gate until baselined
    with a reason."""

    name: str
    file: str
    line: int
    build: Callable[[], dict]


def fold_determinism(spec: FoldSpec) -> List[Finding]:
    rel, model = relpath(spec.file), _model_for(spec.file)

    def refusal(why: str) -> Finding:
        return Finding(
            rule="fold-determinism/refused", severity="warn",
            model=model, file=rel, line=spec.line,
            message=(f"fold {spec.name}: obligations NOT discharged — "
                     f"{why}"),
            hint=("make the fold evaluable on the declared domain, or "
                  "baseline with the reason it cannot be"))

    try:
        d = spec.build()
    except Exception as e:  # refusal semantics: never silently pass
        return [refusal(f"build failed: {type(e).__name__}: {e}")]
    apply_, eq = d["apply"], d["eq"]
    records, starts = d["records"], d["starts"]
    describe = d.get("describe", repr)
    if d.get("trace") is not None:
        try:
            d["trace"]()
        except Exception as e:
            return [refusal(f"trace failed: {type(e).__name__}: {e}")]
    out: List[Finding] = []
    try:
        for s0 in starts:
            for i, a in enumerate(records):
                for b in records[i + 1:]:
                    ab = apply_(apply_(s0, a), b)
                    ba = apply_(apply_(s0, b), a)
                    if not eq(ab, ba):
                        out.append(Finding(
                            rule="fold-determinism/non-commutative",
                            severity="error", model=model, file=rel,
                            line=spec.line,
                            message=(
                                f"fold {spec.name} is order-dependent: "
                                f"applying {describe(a)} then "
                                f"{describe(b)} diverges from the "
                                f"reverse order (replicas apply decided "
                                f"records in per-replica completion "
                                f"order, so this fold diverges under "
                                f"concurrent writes)"),
                            hint=("make the fold commutative: total "
                                  "order with a deterministic tie-break "
                                  "(seq, then value digest)")))
                        if len(out) >= 3:  # witnesses, not a flood
                            return out
    except Exception as e:
        return out + [refusal(f"evaluation failed: "
                              f"{type(e).__name__}: {e}")]
    return out


# ---------------------------------------------------------------------------
# family 4: counter-accounting  +  family 5: obs-vocab (shared sweep)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DynamicNames:
    """One declared dynamic-name emission site: a file whose metric name
    argument is computed, plus the closed set of names it can emit —
    either listed explicitly or harvested from a literal tuple/dict of
    strings assigned to ``names_from`` in the same file."""

    file_suffix: str
    names: Tuple[str, ...] = ()
    names_from: str = ""
    prefix: str = ""


@dataclasses.dataclass(frozen=True)
class CounterPair:
    """A balance invariant between counters: sum(lhs) == sum(rhs) at
    quiescence.  The static obligation: every named counter exists and
    has at least one tick site — losing one side's .inc() breaks the
    accounting silently."""

    label: str
    lhs: Tuple[str, ...]
    rhs: Tuple[str, ...]


@dataclasses.dataclass
class EmissionSweep:
    """Everything the metric/event sweep learned from one set of files."""

    metrics: Dict[str, List[Tuple[str, int, str]]] = \
        dataclasses.field(default_factory=dict)   # name -> [(file,line,kind)]
    events: Dict[str, List[Tuple[str, int]]] = \
        dataclasses.field(default_factory=dict)
    prefixes: Dict[str, List[Tuple[str, int]]] = \
        dataclasses.field(default_factory=dict)   # "chaos." style families
    ticks: Dict[str, List[Tuple[str, int]]] = \
        dataclasses.field(default_factory=dict)   # name -> inc/observe sites
    findings: List[Finding] = dataclasses.field(default_factory=list)


_METRIC_KINDS = ("counter", "gauge", "histogram")
#: objects metric calls hang off: the registry itself and the
#: runtime/stats.py facade (``stats.timer("x")`` etc.)
_METRIC_ROOTS = frozenset({"METRICS", "stats"})
_TICK_METHODS = frozenset({"inc", "dec", "set", "observe", "add"})


def _metric_kind(attr: str) -> Optional[str]:
    """Instrument kind a creation-call attr resolves to (timer is sugar
    over a histogram), or None when the attr is not a creation call."""
    if attr in _METRIC_KINDS:
        return attr
    if attr == "timer":
        return "histogram"
    return None


def _literal_strings_of(tree: ast.Module, var: str) -> List[str]:
    """String constants inside the literal assigned to ``var`` anywhere
    in the file (module or class level) — the closed name domain a
    declared dynamic site draws from."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == var) or \
                        (isinstance(t, ast.Attribute) and t.attr == var):
                    return [n.value for n in ast.walk(node.value)
                            if isinstance(n, ast.Constant)
                            and isinstance(n.value, str)]
    return []


def _joinedstr_prefix(node: ast.JoinedStr) -> str:
    if node.values and isinstance(node.values[0], ast.Constant):
        return str(node.values[0].value)
    return ""


def sweep_emissions(py_files: Sequence[str],
                    dynamic: Sequence[DynamicNames]) -> EmissionSweep:
    """One AST pass over ``py_files``: every METRICS.counter/gauge/
    histogram creation, every TRACE.emit event, every tick site, plus
    counter-accounting/dynamic-name and /type-clash findings."""
    sw = EmissionSweep()
    for path in py_files:
        rel, model = relpath(path), _model_for(path)
        try:
            tree = _parse(path)
        except SyntaxError as e:
            sw.findings.append(Finding(
                rule="counter-accounting/dynamic-name", severity="error",
                model=model, file=rel, line=1,
                message=f"cannot parse {rel}: {e}", hint=""))
            continue
        bound: Dict[str, str] = {}  # var/attr -> metric name
        site_dyn = [d for d in dynamic if path.endswith(d.file_suffix)]

        def dynamic_names_for(node: ast.expr, line: int) -> Optional[
                List[str]]:
            """The declared closed domain for a computed name arg, or
            None when the site is undeclared."""
            if isinstance(node, ast.JoinedStr):
                pre = _joinedstr_prefix(node)
                for d in site_dyn:
                    if d.prefix and pre == d.prefix:
                        sw.prefixes.setdefault(d.prefix, []).append(
                            (rel, line))
                        return []
                    if d.names and pre and any(
                            n.startswith(pre) for n in d.names):
                        return [n for n in d.names if n.startswith(pre)]
            for d in site_dyn:
                if d.names_from:
                    got = _literal_strings_of(tree, d.names_from)
                    if got:
                        return got
                if d.names and not d.prefix and not d.names_from \
                        and not isinstance(node, ast.JoinedStr):
                    return list(d.names)
            return None

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            root = f.value
            # -- creation sites: METRICS.counter("x"), stats.timer("y") --
            kind = _metric_kind(f.attr)
            if kind and isinstance(root, ast.Name) \
                    and root.id in _METRIC_ROOTS and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    sw.metrics.setdefault(arg.value, []).append(
                        (rel, node.lineno, kind))
                else:
                    names = dynamic_names_for(arg, node.lineno)
                    if names is None:
                        sw.findings.append(Finding(
                            rule="counter-accounting/dynamic-name",
                            severity="warn", model=model, file=rel,
                            line=node.lineno,
                            message=(f"METRICS.{f.attr}(...) name is "
                                     f"computed and the site is not in "
                                     f"the DYNAMIC_NAMES registry — the "
                                     f"emitted vocabulary is no longer "
                                     f"statically known"),
                            hint=("declare the closed name set in "
                                  "analysis/runtimerules.py "
                                  "DYNAMIC_NAMES")))
                    else:
                        for n in names:
                            sw.metrics.setdefault(n, []).append(
                                (rel, node.lineno, kind))
            # -- event sites: TRACE.emit("ev", ...) ----------------------
            if f.attr == "emit" and isinstance(root, ast.Name) \
                    and root.id == "TRACE" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    sw.events.setdefault(arg.value, []).append(
                        (rel, node.lineno))
                else:
                    sw.findings.append(Finding(
                        rule="counter-accounting/dynamic-name",
                        severity="warn", model=model, file=rel,
                        line=node.lineno,
                        message=("TRACE.emit(...) event name is computed "
                                 "— the event vocabulary is no longer "
                                 "statically known"),
                        hint="emit a literal event name"))
            # -- tick sites ----------------------------------------------
            if f.attr in _TICK_METHODS:
                # chained: METRICS.counter("x").inc()
                if isinstance(root, ast.Call) \
                        and isinstance(root.func, ast.Attribute) \
                        and root.func.attr in _METRIC_KINDS \
                        and root.args \
                        and isinstance(root.args[0], ast.Constant) \
                        and isinstance(root.args[0].value, str):
                    sw.ticks.setdefault(root.args[0].value, []).append(
                        (rel, node.lineno))
                elif isinstance(root, ast.Name) and root.id in bound:
                    sw.ticks.setdefault(bound[root.id], []).append(
                        (rel, node.lineno))
                elif isinstance(root, ast.Attribute) \
                        and root.attr in bound:
                    sw.ticks.setdefault(bound[root.attr], []).append(
                        (rel, node.lineno))
            # -- bindings: _C_X = METRICS.counter("x") -------------------
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in _METRIC_KINDS \
                    and node.value.args \
                    and isinstance(node.value.args[0], ast.Constant) \
                    and isinstance(node.value.args[0].value, str):
                name = node.value.args[0].value
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        bound[t.id] = name
                    elif isinstance(t, ast.Attribute):
                        bound[t.attr] = name
        # second tick pass now that bindings are complete
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TICK_METHODS:
                root = node.func.value
                key = (root.id if isinstance(root, ast.Name) else
                       root.attr if isinstance(root, ast.Attribute)
                       else None)
                if key in bound:
                    sw.ticks.setdefault(bound[key], []).append(
                        (rel, node.lineno))

    # type clashes across the whole sweep
    for name, sites in sorted(sw.metrics.items()):
        kinds = sorted({k for _f, _l, k in sites})
        if len(kinds) > 1:
            f0 = [s for s in sites if s[2] == kinds[1]][0]
            sw.findings.append(Finding(
                rule="counter-accounting/type-clash", severity="error",
                model=_model_for(f0[0]), file=f0[0], line=f0[1],
                message=(f"metric {name!r} is created as "
                         f"{' and '.join(kinds)} at different sites — "
                         f"the registry get-or-create would raise (or "
                         f"alias) at runtime"),
                hint="one name, one instrument kind"))
    return sw


def counter_pairs(sw: EmissionSweep,
                  pairs: Sequence[CounterPair]) -> List[Finding]:
    out: List[Finding] = []
    for p in pairs:
        for name in tuple(p.lhs) + tuple(p.rhs):
            created = sw.metrics.get(name, [])
            ticked = sw.ticks.get(name, [])
            if created and ticked:
                continue
            anchor = (created or [(relpath(repo_path(
                "round_tpu_torch", "analysis", "runtimerules.py")), 1, "")])[0]
            what = ("never created" if not created
                    else "created but never ticked (.inc/.observe)")
            out.append(Finding(
                rule="counter-accounting/unbalanced-pair",
                severity="error", model=_model_for(anchor[0]),
                file=anchor[0], line=anchor[1],
                message=(f"balance invariant {p.label!r} "
                         f"({' + '.join(p.lhs)} == {' + '.join(p.rhs)}): "
                         f"counter {name!r} is {what} — one side of the "
                         f"accounting is gone and the soak invariant "
                         f"will fail open"),
                hint="restore the tick site or update COUNTER_PAIRS"))
    return out


# -- obs-vocab: both-direction diff against the observability doc ----------

_DOC_METRIC_RE = re.compile(r"`([a-z][a-z0-9_]*\.[a-z0-9_.*]+)`")
_DOC_FIRST_CELL_RE = re.compile(r"^\s*\|([^|]*)\|")
_DOC_PLAIN_TOKEN_RE = re.compile(r"`([a-z][a-z0-9_]*)`")


def parse_doc_vocab(doc_file: str) -> Tuple[Dict[str, int], Dict[str, int],
                                            Dict[str, int], Dict[str, int]]:
    """(metrics, metric_prefixes, events_table, events_any) documented in
    the obs doc, each name -> first line.  Backticked dotted lowercase
    tokens are metric names (``x.*`` forms declare a prefix family);
    backticked plain tokens in table first-columns are event names
    (combined rows like ```a` / `b``` yield all their tokens).
    ``events_any`` is the loose grade — every backticked plain token
    anywhere in the doc — used for the undocumented direction so a prose
    mention counts, while the unemitted direction stays strict to the
    schema table (prose words like `fields` must not register as
    documented events nobody emits)."""
    metrics: Dict[str, int] = {}
    prefixes: Dict[str, int] = {}
    events_table: Dict[str, int] = {}
    events_any: Dict[str, int] = {}
    for i, line in enumerate(_read(doc_file).splitlines(), 1):
        for m in _DOC_METRIC_RE.finditer(line):
            tok = m.group(1)
            if tok.endswith(".*"):
                prefixes.setdefault(tok[:-1], i)
            elif "*" not in tok:
                metrics.setdefault(tok, i)
        cell = _DOC_FIRST_CELL_RE.match(line)
        if cell:
            for em in _DOC_PLAIN_TOKEN_RE.finditer(cell.group(1)):
                events_table.setdefault(em.group(1), i)
        for em in _DOC_PLAIN_TOKEN_RE.finditer(line):
            events_any.setdefault(em.group(1), i)
    return metrics, prefixes, events_table, events_any


def obs_vocab(sw: EmissionSweep, doc_file: str) -> List[Finding]:
    out: List[Finding] = []
    doc_rel = relpath(doc_file)
    try:
        doc_metrics, doc_prefixes, doc_events, doc_any = \
            parse_doc_vocab(doc_file)
    except OSError as e:
        return [Finding(
            rule="obs-vocab/undocumented", severity="error", model="docs",
            file=doc_rel, line=1,
            message=f"cannot read the observability doc: {e}", hint="")]

    def documented(name: str) -> bool:
        return name in doc_metrics or any(
            name.startswith(p) for p in doc_prefixes)

    for name, sites in sorted(sw.metrics.items()):
        if not documented(name):
            f0 = sites[0]
            out.append(Finding(
                rule="obs-vocab/undocumented", severity="error",
                model=_model_for(f0[0]), file=f0[0], line=f0[1],
                message=(f"metric {name!r} is emitted but not documented "
                         f"in {doc_rel} — the vocabulary drifted"),
                hint=f"document it in {doc_rel} (or stop emitting it)"))
    for pre, sites in sorted(sw.prefixes.items()):
        if pre not in doc_prefixes:
            f0 = sites[0]
            out.append(Finding(
                rule="obs-vocab/undocumented", severity="error",
                model=_model_for(f0[0]), file=f0[0], line=f0[1],
                message=(f"metric family {pre + '*'!r} is emitted but "
                         f"{doc_rel} does not document the prefix"),
                hint=f"document `{pre}*` in {doc_rel}"))
    for ev, sites in sorted(sw.events.items()):
        if ev not in doc_events and ev not in doc_any:
            f0 = sites[0]
            out.append(Finding(
                rule="obs-vocab/undocumented", severity="error",
                model=_model_for(f0[0]), file=f0[0], line=f0[1],
                message=(f"trace event {ev!r} is emitted but missing "
                         f"from the {doc_rel} event schema table"),
                hint=f"add a row for `{ev}`"))

    emitted_names = set(sw.metrics)
    emitted_pre = set(sw.prefixes)
    for name, line in sorted(doc_metrics.items()):
        if name not in emitted_names and not any(
                name.startswith(p) for p in emitted_pre):
            out.append(Finding(
                rule="obs-vocab/unemitted", severity="error", model="docs",
                file=doc_rel, line=line,
                message=(f"{doc_rel} documents metric {name!r} but no "
                         f"emission site produces it — dead vocabulary"),
                hint="remove the doc entry or restore the emitter"))
    for pre, line in sorted(doc_prefixes.items()):
        if pre not in emitted_pre and not any(
                n.startswith(pre) for n in emitted_names):
            out.append(Finding(
                rule="obs-vocab/unemitted", severity="error", model="docs",
                file=doc_rel, line=line,
                message=(f"{doc_rel} documents metric family "
                         f"{pre + '*'!r} but nothing emits under it"),
                hint="remove the doc entry or restore the emitter"))
    for ev, line in sorted(doc_events.items()):
        if ev not in sw.events:
            out.append(Finding(
                rule="obs-vocab/unemitted", severity="error", model="docs",
                file=doc_rel, line=line,
                message=(f"{doc_rel} event table documents {ev!r} but no "
                         f"TRACE.emit site produces it"),
                hint="remove the row or restore the emitter"))
    return out


# ---------------------------------------------------------------------------
# the shipped tree's declared registries (runtimelint.default_config())
# ---------------------------------------------------------------------------

#: files swept by the lock-discipline pass: the concurrent serving tier
LOCK_FILES = (
    "round_tpu_torch/runtime/transport.py",
    "round_tpu_torch/runtime/lanes.py",
    "round_tpu_torch/runtime/host.py",
    "round_tpu_torch/runtime/fleet.py",
    "round_tpu_torch/runtime/decisions.py",
    "round_tpu_torch/runtime/health.py",
    "round_tpu_torch/runtime/view.py",
    "round_tpu_torch/runtime/checkpoint.py",
    "round_tpu_torch/runtime/control.py",
    "round_tpu_torch/kv/client.py",
    "round_tpu_torch/kv/reads.py",
    "round_tpu_torch/snap/collect.py",
    "round_tpu_torch/obs/metrics.py",
)

#: pump-owning classes: buffers the native pump holds by pointer
PUMP_SPECS = (
    PumpSpec(file="round_tpu_torch/runtime/lanes.py", class_name="LaneDriver",
             pump_attr="_pump", buffer_attrs=("_boxes",)),
)

#: every receive surface that dispatches on tag flags, with the flags it
#: must handle.  The native C++ surface is pinned separately
#: (DEFAULT_CPP_PINS): its dispatch is kFlagNormal fast path + explicit
#: fallback of everything else to the Python inbox/misc drain.
SURFACES = (
    SurfaceSpec("lanes.client", "round_tpu_torch/runtime/lanes.py",
                "LaneDriver._client_frame",
                frozenset({"FLAG_PROPOSE", "FLAG_SUBSCRIBE", "FLAG_READ",
                           "FLAG_TXN"})),
    SurfaceSpec("lanes.ingest", "round_tpu_torch/runtime/lanes.py",
                "LaneDriver._ingest",
                frozenset({"FLAG_NORMAL", "FLAG_DECISION", "FLAG_NACK",
                           "FLAG_SNAP"})),
    SurfaceSpec("host.mux", "round_tpu_torch/runtime/host.py",
                "InstanceMux._loop_body", frozenset({"FLAG_NORMAL"})),
    SurfaceSpec("host.serve-decisions", "round_tpu_torch/runtime/host.py",
                "serve_decisions", frozenset({"FLAG_NORMAL"})),
    SurfaceSpec("host.drain-misc", "round_tpu_torch/runtime/host.py",
                "HostRunner._pump_round.drain_misc",
                frozenset({"FLAG_NORMAL", "FLAG_DECISION", "FLAG_NACK",
                           "FLAG_SNAP"})),
    SurfaceSpec("host.ingest", "round_tpu_torch/runtime/host.py",
                "HostRunner.run.ingest",
                frozenset({"FLAG_NORMAL", "FLAG_VIEW", "FLAG_DECISION",
                           "FLAG_NACK", "FLAG_SNAP"})),
    SurfaceSpec("oob.pool", "round_tpu_torch/runtime/oob.py",
                "PoolNode.default_handler",
                frozenset({"FLAG_NORMAL", "FLAG_DUMMY", "FLAG_RECOVERY",
                           "FLAG_DECISION", "FLAG_TOO_LATE"})),
    SurfaceSpec("fleet.client", "round_tpu_torch/runtime/fleet.py",
                "FleetRouter._on_frame",
                frozenset({"FLAG_DECISION", "FLAG_NACK", "FLAG_TOO_LATE",
                           "FLAG_READ"})),
    SurfaceSpec("transport.batch-split", "round_tpu_torch/runtime/transport.py",
                "HostTransport._fill", frozenset({"FLAG_BATCH"})),
    SurfaceSpec("chaos.faulty-send", "round_tpu_torch/runtime/chaos.py",
                "FaultyTransport.send", frozenset({"FLAG_NORMAL"})),
    SurfaceSpec("chaos.faulty-recv", "round_tpu_torch/runtime/chaos.py",
                "FaultyTransport._maybe_hold", frozenset({"FLAG_NORMAL"})),
)

#: flags that deliberately have no Python dispatch branch, with reasons
NON_DISPATCH = {
    "FLAG_ERROR": "reserved error byte: never constructed or sent; kept "
                  "in the ledger so the value is not re-allocated",
}

#: declared balance invariants (soak asserts the dynamic side; this pins
#: that both sides' tick sites still exist statically)
COUNTER_PAIRS = (
    CounterPair("shed accounting",
                lhs=("overload.shed_frames",),
                rhs=("overload.nacks_sent", "overload.nacks_suppressed")),
    CounterPair("tenant shed accounting",
                lhs=("tenant.shed_frames",),
                rhs=("tenant.nacks_sent", "tenant.nacks_suppressed")),
)

#: emission sites whose metric name is computed — each declares its
#: closed name domain so the vocabulary stays statically known
DYNAMIC_NAMES = (
    DynamicNames(file_suffix="round_tpu_torch/runtime/transport.py",
                 names_from="_STAT_NAMES"),
    DynamicNames(file_suffix="round_tpu_torch/runtime/chaos.py",
                 prefix="chaos."),
    DynamicNames(file_suffix="round_tpu_torch/rv/dump.py",
                 names=("rv.halts", "rv.sheds", "rv.logged")),
    DynamicNames(file_suffix="round_tpu_torch/kv/reads.py",
                 names=("kv.reads_lin", "kv.reads_lease", "kv.reads_stale",
                        "kv.read_ms_lin", "kv.read_ms_lease",
                        "kv.read_ms_stale")),
)


def default_fold_specs() -> Tuple[FoldSpec, ...]:
    """The shipped SMR folds: the host KVState seq-LWW register fold and
    the torch array rider — both must commute over concurrent writes with
    totally-ordered ties (the divergence class kv/lin.py caught in soak,
    discharged at lint time on a closed domain).  The rider is evaluated
    on small CPU tensors, its digest table held as int64 as the port
    holds it (kv/store.py::kv_array_apply)."""

    def build_host() -> dict:
        from round_tpu_torch.kv import store

        def apply_(state: dict, rec) -> dict:
            st = store.KVState()
            st.data = dict(state)
            st._put_all([rec])
            return st.data

        vals = (b"a", b"b", b"c")
        records = [(seq, b"k", v) for seq in (1, 2) for v in vals]
        starts = [{}, {b"k": (1, b"a")}, {b"k": (2, b"c")}]
        return {
            "apply": apply_, "records": records, "starts": starts,
            "eq": lambda x, y: x == y,
            "describe": lambda r: f"(seq={r[0]}, value={r[2]!r})",
        }

    def build_array() -> dict:
        import torch

        from round_tpu_torch.analysis.tracerules import trace_graph
        from round_tpu_torch.kv import store

        K = 8
        vals = (b"a", b"b", b"c")
        records = [store.encode_record(store.OP_PUT, [(seq, b"k", v)],
                                       payload_bytes=32, keyspace=K)
                   for seq in (1, 2) for v in vals]
        z = (torch.zeros(K, dtype=torch.int32),
             torch.zeros(K, dtype=torch.int64))

        def apply_(state, rec):
            return store.kv_array_apply(state, torch.as_tensor(rec))

        def eq(x, y):
            return bool(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]))

        def trace():
            trace_graph(store.kv_array_apply,
                        (z, torch.zeros(32, dtype=torch.uint8)))

        return {
            "apply": apply_, "records": records, "starts": [z],
            "eq": eq, "trace": trace,
            "describe": lambda r: (f"record(seq={int(r[16])}, "
                                   f"dig={int.from_bytes(bytes(r[10:14].tolist()), 'little'):#x})"),
        }

    from round_tpu_torch.kv import store as _store
    store_py = repo_path("round_tpu_torch", "kv", "store.py")
    wins = getattr(_store.KVState._wins, "__func__",
                   _store.KVState._wins)
    return (
        FoldSpec("kv-host-seq-lww", store_py,
                 wins.__code__.co_firstlineno, build_host),
        FoldSpec("kv-array-seq-lww", store_py,
                 _store.kv_array_apply.__code__.co_firstlineno,
                 build_array),
    )
