"""The port's solver core (round_tpu_torch/verify: formula, futils, typer,
printer, simplify, solver, venn, cl, …) and its ``rtsat`` against
round_tpu's.

  * ``native/sat.cpp`` is round_tpu's byte for byte; the port builds it
    into ``round_tpu_torch/_build/rtsat`` (never under round_tpu's tree),
    and a failed build raises.
  * round_tpu's tests/test_formula.py, test_printer.py and test_cl_grid.py
    run as they are, in round_tpu, while every top-level call they make
    into round_tpu's verifier (a formula constructor, a simplification, a
    printer, a type check, an entailment or a ``solve_ground``) is
    recorded with its arguments and its result.  Each call is then made
    again in the port, on the arguments carried over by
    ``interop.formula_from_round_tpu``, and must give the same printed
    result — the same string, the same simplified formula, the same
    verdict — or raise the same exception.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from test_torch_verifier import canon, counter_start, counters_from

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# rtsat
# ---------------------------------------------------------------------------


def test_sat_cpp_is_round_tpus_byte_for_byte():
    ours = (ROOT / "round_tpu_torch" / "native" / "sat.cpp").read_bytes()
    theirs = (ROOT / "round_tpu" / "native" / "sat.cpp").read_bytes()
    assert ours == theirs


def test_rtsat_builds_into_the_port_and_solves():
    from round_tpu_torch.verify import solver

    exe = pathlib.Path(solver._sat_binary())
    assert exe == ROOT / "round_tpu_torch" / "_build" / "rtsat"
    assert exe.stat().st_mtime >= (
        ROOT / "round_tpu_torch" / "native" / "sat.cpp").stat().st_mtime
    sat = solver.SatSession(2, [[1, 2], [-1, 2]])
    try:
        model = sat.solve(timeout_s=30)
        assert model is not None and model[2]
        sat.add_clause([-2])
        assert sat.solve(timeout_s=30) is None
    finally:
        sat.proc.kill()


def test_rtsat_build_is_fresh_and_never_touches_round_tpu(tmp_path,
                                                           monkeypatch):
    """A sat.cpp newer than the binary is rebuilt; the build writes under
    the port's _build directory only (round_tpu's native/_build is left as
    it was)."""
    from round_tpu_torch.verify import solver

    theirs = ROOT / "round_tpu" / "native" / "_build"
    before = sorted(os.listdir(theirs)) if theirs.exists() else None
    src = tmp_path / "sat.cpp"
    src.write_bytes((ROOT / "round_tpu_torch" / "native" /
                     "sat.cpp").read_bytes())
    exe = tmp_path / "build" / "rtsat"
    monkeypatch.setattr(solver, "_SAT_SRC", str(src))
    monkeypatch.setattr(solver, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(solver, "_SAT_EXE", str(exe))
    monkeypatch.setattr(solver, "_built", False)
    assert solver._sat_binary() == str(exe) and exe.exists()
    first = exe.stat().st_mtime_ns
    os.utime(src, ns=(first + 10**9, first + 10**9))
    monkeypatch.setattr(solver, "_built", False)
    solver._sat_binary()
    assert exe.stat().st_mtime_ns > first
    after = sorted(os.listdir(theirs)) if theirs.exists() else None
    assert after == before


def test_rtsat_failed_build_raises(tmp_path, monkeypatch):
    from round_tpu_torch.verify import solver

    src = tmp_path / "sat.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(solver, "_SAT_SRC", str(src))
    monkeypatch.setattr(solver, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(solver, "_SAT_EXE", str(tmp_path / "build" / "rtsat"))
    monkeypatch.setattr(solver, "_built", False)
    with pytest.raises(subprocess.CalledProcessError):
        solver._sat_binary()
    assert not (tmp_path / "build" / "rtsat").exists()


# ---------------------------------------------------------------------------
# round_tpu's calls, recorded and made again in the port
# ---------------------------------------------------------------------------

MODULES = ("formula", "futils", "typer", "printer", "simplify", "solver",
           "venn", "cl", "lia", "congruence", "quantifiers")



def _functions(mod):
    return {n: f for n, f in vars(mod).items()
            if isinstance(f, types.FunctionType) and not n.startswith("_")
            and f.__module__ == mod.__name__}


@contextlib.contextmanager
def recording(test_ns):
    """Record the calls that the test module's own code makes into round_tpu's
    verifier modules, through the names it imported or through a module
    (the caller's globals are the test module's), as ((module, function),
    carried arguments, printed result, exception type, counter start).
    Calls the verifier makes inside are not recorded.  Each call runs with
    round_tpu's fresh-name counters from a fresh start, and its replay
    with the port's from the same one (``counters_from``)."""
    log = []
    patches = []
    for m in MODULES:
        mod = importlib.import_module(f"round_tpu.verify.{m}")
        for name, fn in _functions(mod).items():
            wrapper = _recorder(fn, (m, name), log, test_ns)
            patches.append((mod.__dict__, name, fn, wrapper))
            for k, v in list(test_ns.items()):
                if v is fn:
                    patches.append((test_ns, k, fn, wrapper))
    # ClReducer(cfg).reduce(f), the reduction itself: replayed as the
    # port's ClReducer(cfg).reduce(f)
    rcl = importlib.import_module("round_tpu.verify.cl")
    reduce_fn = rcl.ClReducer.reduce

    def reduce_method(self, f):
        if sys._getframe(1).f_globals is not test_ns:
            return reduce_fn(self, f)
        try:
            carried = (_carry([self.config, f]), {})
        except _CannotCarry:
            carried = None
        start = counter_start()
        with counters_from("round_tpu", start):
            out = reduce_fn(self, f)
        log.append((("cl", "ClReducer.reduce"), carried, printed(out), None,
                    start))
        return out

    for ns, name, _fn, wrapper in patches:
        ns[name] = wrapper
    rcl.ClReducer.reduce = reduce_method
    try:
        yield log
    finally:
        rcl.ClReducer.reduce = reduce_fn
        for ns, name, fn, _wrapper in patches:
            ns[name] = fn


def _recorder(fn, key, log, test_ns):
    """The call's arguments are carried into the port's classes, and its
    result printed, when the call is made: a verifier object may be
    changed in place later (a VennRegions gains constraints)."""
    def wrapper(*args, **kw):
        if sys._getframe(1).f_globals is not test_ns:
            return fn(*args, **kw)
        try:
            carried = (_carry(list(args)), _carry(dict(kw)))
        except _CannotCarry:
            carried = None
        start = counter_start()
        try:
            with counters_from("round_tpu", start):
                out = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - recorded, then re-raised
            log.append((key, carried, None, type(e).__name__, start))
            raise
        log.append((key, carried, printed(out), None, start))
        return out

    wrapper.__wrapped__ = fn
    return wrapper


class _CannotCarry(Exception):
    pass


_FORMULA_KINDS = ("Literal", "Variable", "Application", "Binding", "BoolT",
                  "IntT", "FSet", "FOption", "FMap", "Product", "FunT",
                  "UnInterpreted", "TVar", "Wildcard", "InterpretedFct",
                  "UnInterpretedFct")


def printed(x) -> str:
    """A result as printed text, fresh names renamed canonically: formulas,
    types and symbols by repr, containers element-wise, plain values by
    repr; any other object by its class name (a solver's working state is
    compared through the verdicts it leads to, not field by field)."""
    def walk(v):
        k = type(v).__name__
        if v is None or isinstance(v, (bool, int, float, str)):
            return repr(v)
        if k in _FORMULA_KINDS:
            return repr(v)
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(walk(y) for y in v) + "]"
        if isinstance(v, (set, frozenset)):
            return "{" + ", ".join(sorted(walk(y) for y in v)) + "}"
        if isinstance(v, dict):
            return "{" + ", ".join(f"{walk(a)}: {walk(b)}"
                                   for a, b in v.items()) + "}"
        return f"<{k}>"

    return canon([walk(x)])[0]


def _carry(x):
    from round_tpu_torch.interop import formula_from_round_tpu

    if isinstance(x, (list, tuple)):
        return type(x)(_carry(y) for y in x)
    if isinstance(x, (set, frozenset)):
        return type(x)(_carry(y) for y in x)
    if isinstance(x, dict):
        return {_carry(a): _carry(b) for a, b in x.items()}
    if callable(x) and not isinstance(x, type):
        raise _CannotCarry(x)
    if (type(x).__module__ or "").startswith("round_tpu.verify"):
        try:
            return formula_from_round_tpu(x)
        except TypeError as e:
            raise _CannotCarry(x) from e
    return x


def replay_in_port(log):
    """Make each recorded call again in the port; returns the number made
    (a call whose arguments hold a callable, a class or a stateful object
    cannot cross and is skipped)."""
    made = 0
    for (m, name), carried, want, exc, start in log:
        if carried is None:
            continue
        pargs, pkw = carried
        mod = importlib.import_module(f"round_tpu_torch.verify.{m}")
        if name == "ClReducer.reduce":
            def fn(cfg, f, mod=mod):
                return mod.ClReducer(cfg).reduce(f)
        else:
            fn = getattr(mod, name)
        try:
            with counters_from("round_tpu_torch", start):
                got, got_exc = fn(*pargs, **pkw), None
        except Exception as e:  # noqa: BLE001 - compared with the reference
            got, got_exc = None, type(e).__name__
        assert got_exc == exc, (m, name, got_exc, exc)
        if exc is None:
            assert printed(got) == want, (m, name)
        made += 1
    return made


def _load(src_name):
    """A fresh copy of round_tpu's tests/<src_name>.py as a module."""
    path = ROOT / "tests" / f"{src_name}.py"
    spec = importlib.util.spec_from_file_location(f"rt_{src_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cases(src_name):
    mod = _load(src_name)
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj):
            out.append(pytest.param(src_name, None, name,
                                    id=f"{src_name}::{name}"))
        elif name.startswith("Test") and isinstance(obj, type):
            for meth in vars(obj):
                if meth.startswith("test_"):
                    out.append(pytest.param(src_name, name, meth,
                                            id=f"{src_name}::{name}::{meth}"))
    return out


_MODS: dict = {}


@pytest.mark.parametrize(
    "src_name,cls,name",
    _cases("test_formula") + _cases("test_printer") + _cases("test_cl_grid"))
def test_round_tpu_case_replays_in_the_port(src_name, cls, name):
    if src_name not in _MODS:
        _MODS[src_name] = _load(src_name)
    mod = _MODS[src_name]
    fn = getattr(getattr(mod, cls)(), name) if cls else getattr(mod, name)
    with recording(vars(mod)) as log:
        fn()
    assert log, "round_tpu's test made no call into its verifier"
    assert replay_in_port(log) > 0
