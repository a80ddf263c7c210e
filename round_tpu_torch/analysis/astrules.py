"""AST passes over round code: purity and recompile-hazard rules.

Port of round_tpu/analysis/astrules.py, its rules retargeted to torch's
idioms for the same defects: host RNG (``np.random``, ``random``, torch's
global-generator draws ``torch.rand*``/``randint``/``randn``/... without a
``generator=``, ``torch.manual_seed``), clock reads, host callbacks and
prints, concretization (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``int()``/``float()`` on a traced value) and Python control
flow on a traced value.  round_tpu's wide-dtype check belonged to the
tpu-lowerability family, which the port does not carry.

These run on the *source* of every round method (send/update/pre and the
EventRound/FoldRound slots) plus the algorithm's traced entry points
(make_init_state, decided, decision).  They catch the defects abstract
tracing cannot see or sees too late:

  purity/*            — effects inside vmapped code: unseeded host RNG,
                        torch's global generator and clock reads give every
                        lane one draw (silent nondeterminism across runs),
                        host callbacks and prints break the pure-function
                        contract, and mutation of closure state
                        (self.x = ...) leaks across vmap lanes.
  recompile-hazard/*  — Python-value-dependent control flow on traced
                        values (``if mbox.size() > 0:``) and forced
                        concretization (int()/float()/.item()/.cpu()/np.*
                        on a traced tensor): under vmap an error, eagerly
                        a host sync per call that a trace would specialise
                        to one value.

The pass is deliberately shallow — one function body at a time, a
fixed-point taint of local names fed from traced parameters (everything
but ``self``/``ctx``) and the traced ``ctx.r``/``ctx.id``/``ctx.rng``
attributes.  Statements guarded by functorch's batched-tensor predicate
(``torch._C._functorch.is_batchedtensor`` / ``is_functorch_wrapped_tensor``,
the port's counterpart of round_tpu's ``isinstance(..., Tracer)`` guard)
are host-only by construction and are skipped; the port's models use no
such guard (their make_init_state always runs under vmap).  Module-level
helpers called from round code are outside its scope; the trace rules
(tracerules.py) cover what they compute.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from round_tpu_torch.analysis.findings import Finding, relpath

#: the Round/EventRound/FoldRound slots the engines trace
ROUND_METHODS = (
    "pre", "send", "update", "receive", "finish_round",
    "zero", "lift", "combine", "post", "go_ahead", "reduce",
    "expected_nbr_messages",
)

#: Algorithm entry points traced by init_lanes / the engines
ALGO_METHODS = ("make_init_state", "decided", "decision")

#: modules whose classes are framework plumbing, never scanned
_FRAMEWORK_PREFIXES = ("round_tpu_torch.core.", "round_tpu_torch.ops.")

_TRACED_CTX_ATTRS = ("ctx.r", "ctx.id", "ctx.rng")

_CLOCK_CALLS = {
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns", "process_time", "process_time_ns",
}

_CONCRETIZE_METHODS = {"item", "tolist", "cpu", "numpy", "__index__",
                       "__int__", "__float__"}

#: torch's draws from the global generator: unseeded unless given a
#: ``generator=``
_TORCH_RANDOM = {"rand", "rand_like", "randint", "randint_like", "randn",
                 "randn_like", "randperm", "bernoulli", "multinomial",
                 "normal", "poisson"}

#: functorch's batched-tensor predicates: the port's host-only-branch guard
_BATCHED_PREDICATES = ("is_batchedtensor", "is_functorch_wrapped_tensor")


def _dotted(node) -> Optional[str]:
    """'np.random.rand' for an Attribute chain rooted at a Name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_isinstance_call(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "isinstance")


def _has_tracer_guard(test) -> bool:
    """True when an if-test dispatches on functorch's batched-tensor
    predicate — the host-only-branch idiom (round_tpu's isinstance(...,
    Tracer)); its guarded body never runs under vmap."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func) or ""
            if d.split(".")[-1] in _BATCHED_PREDICATES:
                return True
    return False


#: attributes that are host-static even on a traced tensor (branching on
#: them is shape dispatch, not value-dependent control flow).  NOTE:
#: `.size` is deliberately absent — Mailbox.size() is the traced message
#: count.
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "dim", "numel",
                 "is_cuda", "layout"}


def _traced(node, tainted: Set[str]) -> bool:
    """Does this expression (transitively) read a traced value?"""
    if _is_isinstance_call(node):
        return False  # isinstance is a host-side type test even on tracers
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False  # x.shape/x.dtype are static attributes of a tracer
    if isinstance(node, ast.Name) and node.id in tainted:
        return True
    if isinstance(node, ast.Attribute) and _dotted(node) in _TRACED_CTX_ATTRS:
        return True
    return any(_traced(c, tainted) for c in ast.iter_child_nodes(node))


def _target_names(target) -> Iterable[str]:
    for sub in ast.walk(target):
        if isinstance(sub, ast.Name):
            yield sub.id


def _collect_taint(fn: ast.FunctionDef) -> Set[str]:
    """Traced parameters + locals assigned from traced expressions, to a
    fixed point (order-free over-approximation)."""
    tainted = {
        a.arg
        for a in (fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs)
        if a.arg not in ("self", "ctx")
    }
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            targets, value = None, None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.NamedExpr):
                targets, value = [node.target], node.value
            if value is None or targets is None:
                continue
            if _traced(value, tainted):
                for t in targets:
                    for name in _target_names(t):
                        if name not in tainted:
                            tainted.add(name)
                            changed = True
    return tainted


class _Scanner:
    def __init__(self, model: str, file: str, tainted: Set[str]):
        self.model = model
        self.file = file
        self.tainted = tainted
        self.findings: List[Finding] = []

    def _emit(self, rule, severity, node, message, hint):
        self.findings.append(Finding(
            rule=rule, severity=severity, model=self.model, file=self.file,
            line=getattr(node, "lineno", 0), message=message, hint=hint,
        ))

    # -- one node's checks --------------------------------------------------

    def _check_call(self, node: ast.Call):
        d = _dotted(node.func) or ""
        root = d.split(".", 1)[0]
        last = d.split(".")[-1]
        if d.startswith(("np.random.", "numpy.random.")) or root == "random" \
                or (root == "torch" and (
                    d in ("torch.manual_seed", "torch.seed")
                    or (last in _TORCH_RANDOM and not any(
                        k.arg == "generator" for k in node.keywords)))):
            self._emit(
                "purity/unseeded-random", "error", node,
                f"host RNG call {d}() inside round code — one draw from a "
                f"global generator, shared by every lane under vmap and "
                f"different on every run",
                "use the per-(scenario, lane, round) word on ctx.rng or "
                "the deterministic hash coin (ops.fused.hash_coin)",
            )
        elif root in ("time", "datetime") and (
                root == "datetime" or d.split(".")[-1] in _CLOCK_CALLS):
            self._emit(
                "purity/time", "error", node,
                f"clock read {d}() inside round code — one host value for "
                f"every lane, different on every run",
                "thread time through the state pytree or ctx.r; wall-clock "
                "belongs to the host runtime, not round code",
            )
        elif d in ("torch.Generator", "torch.cuda.manual_seed",
                   "torch.cuda.manual_seed_all"):
            self._emit(
                "purity/hardcoded-key", "warn", node,
                f"{d}(...) inside round code — a fresh generator or seed "
                f"per round gives every lane and round the same stream",
                "derive randomness from ctx.rng (already unique per "
                "scenario/lane/round)",
            )
        elif d in ("torch.cuda.synchronize", "breakpoint", "pdb.set_trace") \
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "synchronize"):
            self._emit(
                "purity/host-callback", "warn", node,
                f"host callback {d or node.func.attr}() inside round code "
                f"— a host round-trip per invocation; on the card this "
                f"stalls the step",
                "keep round code pure; record into the state pytree and "
                "inspect post-run (obs/trace.py)",
            )
        elif isinstance(node.func, ast.Name) and node.func.id == "print":
            self._emit(
                "purity/host-callback", "warn", node,
                "print() inside round code prints one batched value per "
                "call, never per lane, and syncs with the card — it is not "
                "doing what it looks like",
                "record into the state pytree and inspect post-run; remove "
                "before shipping",
            )
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("int", "float", "bool")
              and any(_traced(a, self.tainted) for a in node.args)):
            self._emit(
                "recompile-hazard/concretize", "error", node,
                f"{node.func.id}() on a traced value — forces "
                f"concretization: an error under vmap, a host sync per "
                f"call outside it",
                "keep the value a tensor (torch.where / .to); only "
                "static config (self.*, ctx.n) may be concretized",
            )
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _CONCRETIZE_METHODS
              and _traced(node.func.value, self.tainted)):
            self._emit(
                "recompile-hazard/concretize", "error", node,
                f".{node.func.attr}() on a traced value forces a host "
                f"transfer/concretization inside round code",
                "keep the value on the device and a tensor",
            )
        elif (root in ("np", "numpy")
              and any(_traced(a, self.tainted) for a in node.args)):
            self._emit(
                "recompile-hazard/concretize", "error", node,
                f"{d}() applied to a traced value — numpy copies its "
                f"arguments to the host (an error under vmap)",
                "use the torch equivalent so the op stays on the device",
            )

    def _check_stmt(self, node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                        and t.value.id in ("self", "ctx"):
                    self._emit(
                        "purity/closure-mutation", "error", t,
                        f"assignment to {t.value.id}.{t.attr} inside round "
                        f"code — closure state mutates once per batched "
                        f"call and leaks across vmap lanes and calls",
                        "round state lives in the state pytree "
                        "(state.replace(...)); signal exit via "
                        "ctx.exit_at_end_of_round",
                    )
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            self._emit(
                "purity/closure-mutation", "error", node,
                f"{'global' if isinstance(node, ast.Global) else 'nonlocal'} "
                f"statement inside traced round code",
                "round functions must be pure per-lane functions of "
                "(ctx, state, mailbox)",
            )

    def _branch_finding(self, kind: str, node):
        self._emit(
            "recompile-hazard/traced-branch", "error", node,
            f"Python {kind} on a traced value — under vmap this is a "
            f"data-dependent control flow error; eagerly it is a host sync "
            f"per call that a trace specialises to one value",
            "express the branch as data: torch.where on the condition (a "
            "lane mask, not control flow)",
        )

    # -- recursive walk (skips Tracer-guarded host-only bodies) -------------

    def visit(self, node):
        if isinstance(node, ast.If) and _has_tracer_guard(node.test):
            for child in node.orelse:
                self.visit(child)
            return
        if isinstance(node, ast.If) and _traced(node.test, self.tainted):
            self._branch_finding("if", node)
        elif isinstance(node, ast.While) and _traced(node.test, self.tainted):
            self._branch_finding("while", node)
        elif isinstance(node, ast.IfExp) and _traced(node.test, self.tainted):
            self._branch_finding("conditional expression", node)
        elif isinstance(node, ast.Assert) and _traced(node.test, self.tainted):
            self._branch_finding("assert", node)
        elif isinstance(node, ast.For) and _traced(node.iter, self.tainted):
            self._branch_finding("for-loop bound", node)
        if isinstance(node, ast.Call):
            self._check_call(node)
        self._check_stmt(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)


def _scannable(cls) -> bool:
    mod = getattr(cls, "__module__", "")
    return not any(mod.startswith(p) for p in _FRAMEWORK_PREFIXES)


def _class_methods(cls, names: Sequence[str]):
    """(method name, function object) for methods *defined on* cls (not
    inherited) whose name is in `names`."""
    for name in names:
        fn = cls.__dict__.get(name)
        if fn is None:
            continue
        fn = getattr(fn, "__func__", fn)
        if callable(fn):
            yield name, fn


def scan_function(model: str, fn) -> List[Finding]:
    """Run the purity/recompile passes over one traced function."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        path = inspect.getsourcefile(fn)
        first = fn.__code__.co_firstlineno
    except (OSError, TypeError):
        return []
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    ast.increment_lineno(tree, first - 1)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    scanner = _Scanner(model, relpath(path), _collect_taint(fdef))
    for stmt in fdef.body:
        scanner.visit(stmt)
    return scanner.findings


def ast_rules(model: str, algo) -> List[Finding]:
    """Purity + recompile-hazard findings for every traced method of the
    algorithm: its rounds' DSL slots and its own traced entry points."""
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()  # (qualified class, method) dedupe

    def scan(cls, names):
        if not _scannable(cls):
            return
        for name, fn in _class_methods(cls, names):
            key = (f"{cls.__module__}.{cls.__qualname__}", name)
            if key in seen:
                continue
            seen.add(key)
            findings.extend(scan_function(model, fn))

    for rnd in getattr(algo, "rounds", ()):
        for cls in type(rnd).__mro__:
            scan(cls, ROUND_METHODS)
    for cls in type(algo).__mro__:
        scan(cls, ALGO_METHODS)
    return findings
