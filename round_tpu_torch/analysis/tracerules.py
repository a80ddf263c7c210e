"""Trace rules: comm-closure and spec-coherence.

Port of round_tpu/analysis/tracerules.py.  round_tpu traces round code
abstractly with ``jax.eval_shape``/``jax.make_jaxpr``; the port traces the
same per-lane functions under the engine's ``torch.func.vmap`` with
``make_fx`` over the functionalized function (verify/extract.py::
trace_lane_fn's machinery), on small example tensors on ``device`` — the
card unless the caller names one.  Round code is traced exactly as the
engine runs it (same vmap shape, same RoundCtx, same Mailbox view).

  comm-closure      — the phase must be communication-closed as a typed
                      program: round r's ``update`` consumes precisely the
                      payload pytree round r's ``send`` produced, and the
                      state pytree is a fixed point across the phase
                      (shape/dtype/structure), because the engine loops
                      over it (executor.run_phases) with ``tree_where``
                      against the previous state.
  spec-coherence    — every field a Spec formula reads must exist in the
                      state pytree: each formula is traced against the
                      state, so a typo surfaces here as a SpecFieldError
                      naming the formula, not as an error inside
                      check_trace after a full run.

round_tpu's third family here, ``tpu-lowerability``, read the TPU dtype
tables of round_tpu/engine/fast.py (TPU_INT_REDUCE_PRIMS, TPU_WIDE_DTYPES,
DOT_DTYPE_PATHS); the port carries none of them, and the family is not
carried either.

A host read of a traced value (``.item()``, ``int(t)``, ``if t:``) has no
``ConcretizationTypeError`` here: make_fx refuses it (a data-dependent
``_local_scalar_dense``) and vmap refuses data-dependent control flow on
a batched tensor.  Both are classified as ``recompile-hazard/concretize``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from round_tpu_torch.analysis.findings import Finding, relpath
from round_tpu_torch.core.rounds import RoundCtx
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.spec.dsl import Env, SpecFieldError

#: message fragments of the refusals a host read of a traced value raises
#: under make_fx (real mode) and under vmap
_CONCRETIZATION_MARKS = (
    "_local_scalar_dense",
    "data-dependent",
    "data dependent",
    "DataDependent",
    ".item()",
)


def _is_concretization(exc: BaseException) -> bool:
    name = type(exc).__name__
    if "DataDependent" in name:
        return True
    msg = str(exc)
    return any(m in msg for m in _CONCRETIZATION_MARKS)


def _short(exc: BaseException, limit: int = 300) -> str:
    msg = str(exc).strip().split("\n")[0]
    return msg[:limit] + ("…" if len(msg) > limit else "")


def _fn_anchor(fn) -> Tuple[str, int]:
    fn = getattr(fn, "__func__", fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        return "<unknown>", 0
    return relpath(code.co_filename), code.co_firstlineno


def resolve_device(device) -> torch.device:
    """The device a trace runs on: the card unless the caller names one;
    raises where there is none (the port's rule for every entry point)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the analysis traces round code on the CUDA device by "
                "default and none is available; pass device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def _dtype_name(t) -> str:
    return str(torch.as_tensor(t).dtype).replace("torch.", "")


def _leaf_sig(x) -> str:
    t = torch.as_tensor(x)
    return f"{_dtype_name(t)}[{', '.join(map(str, t.shape))}]"


def flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in torch's pytree leaf order (the order make_fx
    numbers its placeholders), each path written as jax.tree_util.keystr
    writes it: ``.field`` for a struct field, ``['key']`` for a dict key,
    ``[i]`` for a sequence index."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{path}.{f.name}")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def _tree_sig(tree) -> dict:
    return {path: _leaf_sig(leaf) for path, leaf in flatten_with_names(tree)}


def trace_graph(fn, args, ran: bool = False):
    """The aten graph of ``fn(*args)``: make_fx over the functionalized
    function, dead nodes dropped (verify/extract.py::trace_lane_fn without
    its extraction switches), traced with fake tensors (real mode makes a
    fake-tensor mode per op for its metadata, which cost most of a lint
    sweep).  Only the graph is read: the module is not recompiled.
    Raises what the trace raises; a host read of a traced value raises a
    data-dependent error.

    ``fn`` runs once on the example tensors first (unless the caller just
    ran it, ``ran``): round code may keep per-device copies of its
    constants (models/gameoflife.py's overlay), and a first call under the
    fake trace would leave a fake tensor in such a cache."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if not ran:
        fn(*args)

    def call(*a):
        # make_fx reads the traced function's signature: a bound method or
        # a function with defaulted parameters would miscount the inputs
        return fn(*a)

    gm = make_fx(torch.func.functionalize(
        call, remove="mutations_and_views"), tracing_mode="fake",
        _allow_non_fake_inputs=True)(*args)
    gm.graph.eliminate_dead_code()
    return gm


def traced_call(fn, *args):
    """Evaluate ``fn`` on the example tensors for the typed outputs the
    checks read, then trace it (refusing host reads and data-dependent
    control flow, as an abstract trace would)."""
    out = fn(*args)
    trace_graph(fn, args, ran=True)
    return out


class _RoundTracer:
    """Traces one model's phase round-by-round, mirroring executor.run_round
    (pre → send → exchange → update) on example tensors on ``device``."""

    #: the mailbox view update receives (threshold.py passes a subclass
    #: that marks the mailbox's count products in the graph)
    mailbox_cls = Mailbox

    def __init__(self, model: str, n: int, algo, device=None):
        self.model = model
        self.n = n
        self.algo = algo
        self.device = resolve_device(device)
        dev = self.device
        self.ids = torch.arange(n, dtype=torch.int32, device=dev)
        self.r = torch.zeros((), dtype=torch.int32, device=dev)
        self.ho = torch.ones((n, n), dtype=torch.bool, device=dev)
        self.keys = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.findings: List[Finding] = []

    def _emit(self, rule, severity, anchor, message, hint=""):
        file, line = anchor
        self.findings.append(Finding(
            rule=rule, severity=severity, model=self.model,
            file=file, line=line, message=message, hint=hint,
        ))

    def _classify_trace_failure(self, exc, rule, anchor, what, hint):
        if _is_concretization(exc):
            self._emit(
                "recompile-hazard/concretize", "error", anchor,
                f"{what} reads a traced value on the host while tracing "
                f"(the engine vmaps this code): {_short(exc)}",
                "express the branch/value as data (torch.where, .to); "
                "see recompile-hazard in docs/ANALYSIS.md",
            )
        else:
            self._emit(rule, "error", anchor,
                       f"{what} failed to trace: "
                       f"{type(exc).__name__}: {_short(exc)}", hint)

    # -- per-round tracing --------------------------------------------------

    def _send_fn(self, rnd):
        n, ids = self.n, self.ids

        def f(state, r):
            def per_lane(i, s):
                ctx = RoundCtx(id=i, n=n, r=r)
                s = rnd.pre(ctx, s)
                spec = rnd.send(ctx, s)
                return s, spec.payload, spec.dest_mask

            return vmap(per_lane)(ids, state)

        return f

    def _update_fn(self, rnd):
        n, ids, mailbox = self.n, self.ids, self.mailbox_cls

        def f(state, payload, deliver, keys, r):
            def per_lane(i, s, mbox_mask, k):
                ctx = RoundCtx(id=i, n=n, r=r, rng=k)
                s2 = rnd.update(ctx, s, mailbox(payload, mbox_mask))
                return s2, ctx._exit

            return vmap(per_lane)(ids, state, deliver, keys)

        return f

    def round_fn(self, rnd):
        """One whole round (send, the masked transpose, update) as one
        function of (state, r, ho, keys) returning the new state."""
        send, update = self._send_fn(rnd), self._update_fn(rnd)

        def f(state, r, ho, keys):
            state1, payload, dest = send(state, r)
            deliver = ho & dest.T
            new_state, _exit = update(state1, payload, deliver, keys, r)
            return new_state

        return f

    def trace_round(self, j: int, rnd, state):
        """Returns the post-round state, or None when tracing stopped."""
        send_anchor = _fn_anchor(type(rnd).send)
        upd_anchor = _fn_anchor(type(rnd).update)

        try:
            state1, payload, dest = traced_call(
                self._send_fn(rnd), state, self.r)
        except Exception as e:  # noqa: BLE001 — every failure is a finding
            self._classify_trace_failure(
                e, "comm-closure/send", send_anchor,
                f"round {j}'s send (example state, traced ids)",
                "send must be a pure per-lane function "
                "(ctx, state) -> SendSpec over the state pytree",
            )
            return None

        if tuple(dest.shape) != (self.n, self.n) or \
                dest.dtype != torch.bool:
            self._emit(
                "comm-closure/dest-mask", "error", send_anchor,
                f"round {j}'s send produced a dest_mask of "
                f"{_leaf_sig(dest)}; the wire contract is bool[n] per "
                f"lane (bool[{self.n}, {self.n}] after the engine's vmap)",
                "build the mask with broadcast()/unicast()/silence() "
                "(core/rounds.py) instead of hand-rolling shapes",
            )
            return None

        deliver = self.ho & dest.T
        try:
            new_state, exit_flags = traced_call(
                self._update_fn(rnd), state1, payload, deliver,
                self.keys, self.r)
        except Exception as e:  # noqa: BLE001
            self._classify_trace_failure(
                e, "comm-closure/mailbox", upd_anchor,
                f"round {j}'s update, consuming the mailbox built from its "
                f"own send's payload "
                f"(payload leaves: {_tree_sig(payload)})",
                "update may only consume the payload pytree send produced "
                "— same keys, same leaf shapes/dtypes",
            )
            return None

        if torch.as_tensor(exit_flags).dtype != torch.bool:
            self._emit(
                "comm-closure/exit-flag", "error", upd_anchor,
                f"round {j}'s exit_at_end_of_round mask has dtype "
                f"{_dtype_name(exit_flags)}, expected bool",
                "pass a bool lane mask to ctx.exit_at_end_of_round",
            )

        before, after = _tree_sig(state), _tree_sig(new_state)
        if before != after:
            drift = []
            for key in sorted(set(before) | set(after)):
                a, b = before.get(key), after.get(key)
                if a != b:
                    drift.append(f"{key}: {a or '<absent>'} -> {b or '<absent>'}")
            self._emit(
                "comm-closure/state-drift", "error", upd_anchor,
                f"round {j}'s update changed the state pytree's typed "
                f"structure — the engine loops the phase, so the state "
                f"must be a shape/dtype fixed point; drift: "
                f"{'; '.join(drift)}",
                "cast the offending field back to its declared dtype "
                "(.to) or fix the field's construction in "
                "make_init_state",
            )
            return None
        return new_state

    def trace_phase(self, state):
        for j, rnd in enumerate(self.algo.rounds):
            nxt = self.trace_round(j, rnd, state)
            if nxt is None:
                return None
            state = nxt
        return state

    # -- decided/decision accessors ----------------------------------------

    def check_accessors(self, state):
        for name, want in (("decided", torch.bool), ("decision", None)):
            fn = getattr(self.algo, name)
            try:
                out = traced_call(fn, state)
            except NotImplementedError:
                continue  # the engine tolerates missing accessors
            except Exception as e:  # noqa: BLE001
                self._emit(
                    "comm-closure/accessor", "error",
                    _fn_anchor(type(self.algo).__dict__.get(name, fn)),
                    f"{name}(state) failed to trace on the example state: "
                    f"{type(e).__name__}: {_short(e)}",
                    "accessors are traced by the engine every round; they "
                    "must be pure functions of the state pytree",
                )
                continue
            leaves = [torch.as_tensor(x) for x in pytree.tree_leaves(out)]
            # decided must be exactly [n] bool; decision is per-lane values
            # of any width ([n], or [n, B] byte/bitset payloads) — only the
            # leading lane axis is the contract
            bad = len(leaves) != 1 or (
                tuple(leaves[0].shape) != (self.n,)
                if want is torch.bool
                else (leaves[0].dim() < 1 or leaves[0].shape[0] != self.n)
            ) or (want is not None and leaves[0].dtype != want)
            if bad:
                self._emit(
                    "comm-closure/accessor", "warn",
                    _fn_anchor(type(self.algo).__dict__.get(name, fn)),
                    f"{name}(state) returned "
                    f"{[_leaf_sig(l) for l in leaves]}; the engine expects "
                    f"one [{self.n}{', …' if want is None else ''}]-shaped"
                    f"{' bool' if want is torch.bool else ''} vector",
                    "return a per-lane vector over the vmapped state",
                )


# -- spec-coherence ---------------------------------------------------------


def _spec_formulas(spec):
    """(label, formula, has_old): has_old mirrors the Env check_trace will
    actually build — the safety_predicate is evaluated on a pre-state Env
    with NO old snapshot (spec/check.py), so a safety formula touching
    ``i.old`` must fail the lint, not just the run."""
    from round_tpu_torch.spec.check import formula_label

    if spec is None:
        return
    for i, f in enumerate(getattr(spec, "invariants", ()) or ()):
        yield formula_label(f, f"invariants[{i}]"), f, True
    for name, f in getattr(spec, "properties", ()) or ():
        yield f"property {name!r}", f, True
    sp = getattr(spec, "safety_predicate", None)
    if sp is not None:
        yield formula_label(sp, "safety_predicate"), sp, False
    for i, f in enumerate(getattr(spec, "liveness_predicate", ()) or ()):
        yield formula_label(f, f"liveness_predicate[{i}]"), f, True
    for j, group in enumerate(getattr(spec, "round_invariants", ()) or ()):
        for m, f in enumerate(group):
            yield formula_label(f, f"round_invariants[{j}][{m}]"), f, True


def spec_coherence(model: str, tracer: _RoundTracer, state_sds) -> None:
    """Trace every spec formula against ``state_sds``, the example state
    (round_tpu's abstract one)."""
    state = state_sds
    spec = getattr(tracer.algo, "spec", None)
    if spec is None:
        return
    n = tracer.n

    for label, f, has_old in _spec_formulas(spec):
        anchor = _fn_anchor(f)

        def run(st, init0, ho, r, _f=f, _old=has_old):
            return torch.as_tensor(_f(Env(state=st, n=n,
                                          old=st if _old else None,
                                          init0=init0, ho=ho, r=r)))

        try:
            out = traced_call(run, state, state, tracer.ho, tracer.r)
        except SpecFieldError as e:
            e = e.with_formula(label)
            tracer._emit(
                "spec-coherence/missing-field", "error", anchor,
                str(e),
                "fix the field name in the formula (or add the field to "
                "the state pytree); state fields listed in the message",
            )
            continue
        except Exception as e:  # noqa: BLE001
            tracer._emit(
                "spec-coherence/trace-error", "error", anchor,
                f"{label} failed to evaluate on the example state: "
                f"{type(e).__name__}: {_short(e)}",
                "spec formulas must be Env -> bool-scalar reductions over "
                "existing state fields (spec/dsl.py)",
            )
            continue
        if tuple(out.shape) != () or out.dtype != torch.bool:
            tracer._emit(
                "spec-coherence/nonbool", "warn", anchor,
                f"{label} evaluates to {_leaf_sig(out)}; the checker "
                f"expects a scalar bool per step",
                "finish the formula with a quantifier/reduction "
                "(P.forall / .all())",
            )


# -- entry point ------------------------------------------------------------


def init_state(algo, io, n: int, device):
    """The per-lane initial state on ``device`` (executor.init_lanes)."""
    from round_tpu_torch.engine.executor import LocalTopology, init_lanes

    return init_lanes(algo, io, n, LocalTopology(n, device=device))


def trace_rules(model: str, n: int, algo, io, device=None) -> List[Finding]:
    """All trace findings for one model, traced on ``device``
    (round_tpu/analysis/tracerules.py::trace_rules, less the TPU family)."""
    tracer = _RoundTracer(model, n, algo, device)
    try:
        state = traced_call(
            lambda io_: init_state(algo, io_, n, tracer.device),
            pytree.tree_map(lambda x: torch.as_tensor(x).to(tracer.device),
                            io))
    except Exception as e:  # noqa: BLE001
        tracer._classify_trace_failure(
            e, "comm-closure/init",
            _fn_anchor(type(algo).make_init_state),
            "make_init_state (vmapped over the io pytree)",
            "make_init_state must build the per-lane state from the "
            "per-lane io slice without reading it on the host",
        )
        return tracer.findings

    tracer.trace_phase(state)
    tracer.check_accessors(state)
    spec_coherence(model, tracer, state)
    return tracer.findings
