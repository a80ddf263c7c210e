"""The port's verifier (round_tpu_torch/verify) against round_tpu's, on the
tier-1 verification suites.

round_tpu's own suites run over the port: each file's source is executed
once more with ``round_tpu.verify`` read as ``round_tpu_torch.verify``
(its "port twin"), so every test below is one of round_tpu's tests, with
its fixtures, parameters and markers (what round_tpu marks ``slow`` stays
``slow``), asserting round_tpu's verdicts about the port's solver and the
port's copy of the hand proofs.  Each test says how its verdicts are held:

  * ``[both]`` — round_tpu's run of it takes under about 3 s; every
    verdict the port computes at the top level (``cl.entailment``,
    ``cl.reduce``, ``solver.solve_ground``) is carried back into
    round_tpu's classes and computed by round_tpu too, and the two must
    be equal;
  * ``[asserted]`` — the port's verdicts are held against the ones
    round_tpu's own test asserts (a heavy test, or one whose VCs carry a
    stateful tactic that does not cross packages).

Besides, the printed VC trees of the hand-proof specs must equal
round_tpu's: ``dump`` prints a verifier object tree field by field, and
the fresh names that global counters make (the extraction sites
``ext!…`` among them) are renamed canonically, in the order they first
occur, before two dumps are compared (``canon``, the rule stated once
in round_tpu_torch/verify/extract.py and used by chip_smoke.py too).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import pathlib
import re
import threading
import types

import pytest
import torch

from round_tpu_torch.verify.extract import canon

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# Printing and carrying verifier objects
# ---------------------------------------------------------------------------

def dump(x, depth=0) -> str:
    """A printed verifier object tree: formulas by repr, VCs, specs and
    chains field by field, containers element-wise; callables by name."""
    if depth > 40:
        raise RecursionError("dump too deep")
    k = type(x).__name__
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    if k in ("Literal", "Variable", "Application", "Binding", "BoolT",
             "IntT", "FSet", "FOption", "FMap", "Product", "FunT",
             "UnInterpreted", "TVar", "Wildcard", "InterpretedFct",
             "UnInterpretedFct"):
        return repr(x)
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(dump(y, depth + 1) for y in x) + "]"
    if isinstance(x, (set, frozenset)):
        return "{" + ", ".join(sorted(dump(y, depth + 1) for y in x)) + "}"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{dump(a, depth + 1)}: {dump(b, depth + 1)}"
                               for a, b in x.items()) + "}"
    if isinstance(x, (types.FunctionType, types.MethodType,
                      functools.partial)):
        return f"<fn {getattr(x, '__qualname__', k)}>"
    if dataclasses.is_dataclass(x):
        return k + "(" + ", ".join(
            f"{f.name}={dump(getattr(x, f.name), depth + 1)}"
            for f in dataclasses.fields(x)) + ")"
    if hasattr(x, "__dict__"):
        return k + "(" + ", ".join(
            f"{a}={dump(b, depth + 1)}" for a, b in sorted(vars(x).items())
            if a not in ("status", "solve_time_s")) + ")"
    return f"<{k}>"


# the verifier's module-level counters of fresh names
COUNTERS = (("cl", "_fresh"), ("formula", "_tvar_counter"),
            ("futils", "_fresh_counter"), ("quantifiers", "_fresh_counter"),
            ("venn", "_counter"))


_BAND = 10 ** 7


def counter_start() -> int:
    """A value above every fresh-name counter of both packages, rounded to
    a band: counters set from it (``set_counters``) issue names no earlier
    name of the process has."""
    import importlib

    top = 0
    for pkg in ("round_tpu", "round_tpu_torch"):
        for m, attr in COUNTERS:
            top = max(top, next(getattr(
                importlib.import_module(f"{pkg}.verify.{m}"), attr)))
    return _BAND * (1 + top // _BAND)


@contextlib.contextmanager
def counters_from(pkg: str, start: int):
    """Within this context, ``pkg``'s fresh-name counters run from
    ``start``, each counter in a band of its own (two counters may share a
    stem); they stay advanced after it.  tr.py names a mailbox's bound
    variable and a round's payload functions after ``id(self) % 10_000``,
    a memory address, which can coincide between two objects in one
    package and not in the other: inside the context its ``id`` is a
    counter from 1, and the builtin again after."""
    import importlib
    import itertools

    for k, (m, attr) in enumerate(COUNTERS):
        setattr(importlib.import_module(f"{pkg}.verify.{m}"), attr,
                itertools.count(start + (k + 1) * _BAND))
    tr = importlib.import_module(f"{pkg}.verify.tr")
    ids = itertools.count(1)
    tr.id = lambda _obj: next(ids)
    try:
        yield
    finally:
        del tr.id


def built_alike(rt_build, pt_build):
    """Build an object tree in each package from the same values of the
    fresh-name counters: a counter's value decides a name, a name its
    hash, and a set of names its iteration order, which can reorder bound
    variables or conjuncts."""
    start = counter_start()
    with counters_from("round_tpu", start):
        rt = rt_build()
    with counters_from("round_tpu_torch", start):
        return rt, pt_build()


def dumps_equal(rt_obj, pt_obj):
    """Assert that two object trees print alike (``dump``, then ``canon``
    on each print); a mismatch names the first difference."""
    a, b = canon([dump(rt_obj)])[0], canon([dump(pt_obj)])[0]
    if a != b:
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        lo = max(0, i - 200)
        raise AssertionError(f"prints differ at {i}:\nround_tpu: "
                             f"{a[lo:i + 200]}\nport:      {b[lo:i + 200]}")
    return a


def to_round_tpu(x):
    """Carry a port verifier object into round_tpu's classes (the reverse
    of interop.formula_from_round_tpu); containers element-wise, other
    values as they are.  Raises TypeError for what cannot cross (a
    stateful tactic or a QI logger in a ClConfig)."""
    from round_tpu.verify import cl as rcl, formula as rf, vc as rvc
    from round_tpu_torch.interop import carry_formula

    if isinstance(x, (list, tuple)):
        return type(x)(to_round_tpu(y) for y in x)
    if isinstance(x, dict):
        return {to_round_tpu(a): to_round_tpu(b) for a, b in x.items()}
    mod = type(x).__module__ or ""
    if mod.startswith("round_tpu_torch.verify"):
        return carry_formula(x, rf, rvc, rcl.ClConfig)
    return x


# ---------------------------------------------------------------------------
# Recording the port's top-level verdicts
# ---------------------------------------------------------------------------

# (module, function) pairs whose outermost calls are verdicts
VERDICTS = (("cl", "entailment"), ("cl", "reduce"),
            ("solver", "solve_ground"))

_depth = threading.local()


@contextlib.contextmanager
def recording(pkg: str, namespaces=(), targets=VERDICTS):
    """Within this context, the outermost calls of ``pkg.verify.<module>.
    <function>`` for each target are recorded as ((module, function), args,
    kwargs, result, counter start); calls made inside a recorded call are
    not.  The
    functions are replaced in their module and in every namespace in
    ``namespaces`` that imported them by name."""
    import importlib

    log = []
    patches = []
    for mod_name, fn_name in targets:
        mod = importlib.import_module(f"{pkg}.verify.{mod_name}")
        orig = getattr(mod, fn_name)
        wrapper = _recorder(orig, (mod_name, fn_name), log)
        patches.append((mod.__dict__, fn_name, orig, wrapper))
        for ns in namespaces:
            if ns.get(fn_name) is orig:
                patches.append((ns, fn_name, orig, wrapper))
    for ns, name, _orig, wrapper in patches:
        ns[name] = wrapper
    try:
        yield log
    finally:
        for ns, name, orig, _wrapper in patches:
            ns[name] = orig


def _recorder(orig, key, log):
    """A top-level call runs with the port's counters from a fresh start
    (``counters_from``), which the replay in round_tpu takes too."""
    @functools.wraps(orig)
    def wrapper(*args, **kw):
        d = getattr(_depth, "n", 0)
        if d:
            return orig(*args, **kw)
        start = counter_start()
        _depth.n = 1
        try:
            with counters_from("round_tpu_torch", start):
                out = orig(*args, **kw)
        finally:
            _depth.n = 0
        log.append((key, args, kw, out, start))
        return out

    return wrapper


def replay_in_round_tpu(log):
    """Compute each recorded verdict again in round_tpu, on the carried
    arguments; returns how many were replayed (records whose arguments
    cannot cross are skipped)."""
    import importlib

    done = 0
    for (mod_name, fn_name), args, kw, out, start in log:
        try:
            rargs, rkw = to_round_tpu(list(args)), to_round_tpu(dict(kw))
        except TypeError:
            continue
        fn = getattr(importlib.import_module(f"round_tpu.verify.{mod_name}"),
                     fn_name)
        with counters_from("round_tpu", start):
            ref = fn(*rargs, **rkw)
        if fn_name == "reduce":
            assert canon([repr(out)]) == canon([repr(ref)]), fn_name
        else:
            assert out == ref, (fn_name, out, ref)
        done += 1
    return done


# ---------------------------------------------------------------------------
# Port twins of round_tpu's test files
# ---------------------------------------------------------------------------

# a call of an extracted builder, or of a suite built on one
_BUILDER_CALL = re.compile(
    r"\b((?:otr|lv|epsilon|tpce|lve|floodmin|kset|benor)_extracted_"
    r"(?:tr|stage_vcs|vcs|lemmas)|pbft_vc_(?:selection_extracted|"
    r"extracted_lemmas))\(([^()]*)\)")


def twin_namespace(src_name: str) -> dict:
    """round_tpu's ``tests/<src_name>.py`` executed over the port's
    verifier: its ``round_tpu.verify`` imports read ``round_tpu_torch.
    verify``.  Other imports (round_tpu's engine in test_tpc) are left as
    they are."""
    path = ROOT / "tests" / f"{src_name}.py"
    src = path.read_text().replace("round_tpu.verify",
                                   "round_tpu_torch.verify")
    # conftest's drop_ho_conjuncts reads round_tpu's HO symbol: the twin
    # gets the same helper over the port's
    src = src.replace("from conftest import drop_ho_conjuncts", "pass")
    # the extracted builders trace on the card unless told otherwise
    src = _BUILDER_CALL.sub(
        lambda m: f"{m.group(1)}({m.group(2)}{', ' if m.group(2) else ''}"
                  f"device='cpu')", src)
    ns = {"__name__": f"port_twin_{src_name}", "__file__": str(path),
          "drop_ho_conjuncts": _port_conftest()["drop_ho_conjuncts"]}
    exec(compile(src, f"<port twin of tests/{src_name}.py>", "exec"), ns)
    return ns


@functools.lru_cache(maxsize=None)
def _port_conftest() -> dict:
    """tests/conftest.py's ``drop_ho_conjuncts`` over the port's verifier."""
    src = (ROOT / "tests" / "conftest.py").read_text()
    a = src.index("def drop_ho_conjuncts(")
    b = src.find("\ndef ", a + 1)
    src = src[a:b if b > 0 else len(src)].replace(
        "round_tpu.verify", "round_tpu_torch.verify")
    ns: dict = {}
    exec(compile(src, "<port twin of tests/conftest.py>", "exec"), ns)
    return ns


def install_twins(module_globals, src_name, asserted, only=None):
    """Expose each test of round_tpu's ``src_name`` (those for which
    ``only(name)`` holds, if given) as a test of the calling module, run
    over the port.  ``asserted`` maps the tests held to round_tpu's
    asserted verdicts to the reason, or to (reason, cases) where only the
    parameter cases for which ``cases(kwargs)`` holds are; the others are
    ``[both]``.  Fixtures defined by the file are exposed too."""
    ns = twin_namespace(src_name)
    for name, obj in list(ns.items()):
        if getattr(obj, "_fixture_function_marker", None) is not None or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            module_globals[name] = obj
    names = [n for n, o in ns.items()
             if n.startswith("test_") and callable(o)]
    missing = set(asserted) - set(names)
    assert not missing, missing
    if only is not None:
        names = [n for n in names if only(n)]
    for name in names:
        fn = ns[name]
        reason = asserted.get(name)
        cases = None
        if isinstance(reason, tuple):
            # asserted only for the parameter cases in reason[1]
            reason, cases = reason

        @functools.wraps(fn)
        def test(*args, __fn=fn, __reason=reason, __cases=cases, __ns=ns,
                 **kw):
            with recording("round_tpu_torch", [__ns]) as log:
                __fn(*args, **kw)
            both = __reason is None or (
                __cases is not None and not __cases(kw))
            if both:
                replay_in_round_tpu(log)

        if reason is None:
            mode = "[both]"
        elif cases is None:
            mode = f"[asserted] — {reason}"
        else:
            mode = f"[both; asserted where {cases.__doc__}] — {reason}"
        test.__doc__ = f"{mode}: round_tpu tests/{src_name}.py::{name}"
        assert name not in module_globals, name
        module_globals[name] = test
    return ns


_HEAVY = "round_tpu's run takes over 3 s; the port's verdicts are held to " \
         "the ones it asserts"
_TACTIC = "its VCs carry a stateful tactic, which does not cross packages"

# OTR's suite of test_verifier.py runs in test_torch_verifier_otr.py
OTR_ASSERTED = {
    "test_otr_mor_lemma": _HEAVY,
    "test_otr_mor_lemma_needs_quorum": _HEAVY,
    "test_otr_progress_requires_magic_round": _HEAVY,
    "test_otr_verifies_end_to_end": _HEAVY,
}
install_twins(globals(), "test_verifier", {
    **OTR_ASSERTED,
    "test_erb_flood_walk_and_liveness_control": _HEAVY,
    "test_erb_unguarded_send_rejected": _HEAVY,
    "test_tpc_broken_invariant_rejected": _HEAVY,
    "test_tpc_verifies": _HEAVY,
}, only=lambda name: not name.startswith("test_otr"))
install_twins(globals(), "test_logic", {})
install_twins(globals(), "test_tpc", {
    "test_tpc_phase_walk_and_liveness_control": _HEAVY,
}, only=lambda name: name == "test_tpc_phase_walk_and_liveness_control")
install_twins(globals(), "test_matching", {})
install_twins(globals(), "test_tactics", {
    "test_cl_entailment_with_tactic": _TACTIC,
    "test_cl_tactic_depth0_is_incomplete_control": _TACTIC,
})
install_twins(globals(), "test_vs", {})
install_twins(globals(), "test_zab", {})


# ---------------------------------------------------------------------------
# The hand-proof specs: printed VC trees equal round_tpu's
# ---------------------------------------------------------------------------

SPECS = ["tpc_spec", "otr_spec", "erb_spec", "lv_verifier_spec"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_vc_tree_prints_as_round_tpu(spec):
    import round_tpu.verify.protocols as rp
    import round_tpu.verify.verifier as rv
    import round_tpu_torch.verify.protocols as pp
    import round_tpu_torch.verify.verifier as pv

    rt, pt = built_alike(
        lambda: rv.Verifier(getattr(rp, spec)()).generate_vcs(),
        lambda: pv.Verifier(getattr(pp, spec)()).generate_vcs())
    assert len(rt) == len(pt) > 0
    dumps_equal(rt, pt)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_prints_as_round_tpu(spec):
    """The spec object itself, field by field (rounds, invariants,
    properties, staged chains, configs)."""
    import round_tpu.verify.protocols as rp
    import round_tpu_torch.verify.protocols as pp

    dumps_equal(*built_alike(getattr(rp, spec), getattr(pp, spec)))


def test_recording_sees_nested_verdicts_once():
    """The harness itself: solving a VC tree records one entailment per
    SingleVC solved (at the top level, none of the calls inside), and the
    replay in round_tpu gives the same verdicts."""
    import round_tpu_torch.verify.protocols as pp
    from round_tpu_torch.verify.vc import CompositeVC
    from round_tpu_torch.verify.verifier import Verifier

    vc = Verifier(pp.tpc_spec()).generate_vcs()[0]
    with recording("round_tpu_torch") as log:
        vc.solve()

    def leaves(v):
        if isinstance(v, CompositeVC):
            return sum((leaves(c) for c in v.children), [])
        return [v] if v.status is not None else []

    solved = leaves(vc)
    assert len(log) == len(solved) > 0
    assert all(key == ("cl", "entailment") for key, *_ in log)
    assert [rec[3] for rec in log] == [v.status for v in solved]
    assert replay_in_round_tpu(log) == len(solved)
