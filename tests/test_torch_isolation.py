"""The port stands alone: round_tpu_torch and chip_smoke.py import no jax,
no flax and nothing of round_tpu (only the tests import both packages)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "round_tpu")
# the runtime's modules: in-process, the wire, the host runner, the lane
# driver and the fleet
RUNTIME = ("__init__", "log", "stats", "membership", "decisions", "config",
           "health", "instances", "oob", "capacity", "checkpoint", "smr",
           "view", "codec", "transport", "host", "control", "chaos",
           "lanes", "fleet")
# the apps of the host runner and the fleet
HOST_APPS = ("perf_ab", "host_replica", "host_perftest", "lock_manager",
             "loadgen", "fleet")
# the verification plane: runtime verification, snapshot fixtures, the
# artifact replay, the hostile-wire gate, the crosscheck and their CLI
VERIFY = ("rv/__init__", "rv/compile", "rv/dump", "rv/license",
          "rv/fixtures", "snap/__init__", "snap/sample", "snap/collect",
          "snap/audit", "snap/driver", "snap/fixtures", "fuzz/replay",
          "fuzz/hostile", "byz/crosscheck", "apps/fuzz_cli",
          "apps/snap_cli")
# the replicated key-value store and its CLI
KV = ("kv/__init__", "kv/store", "kv/reads", "kv/txn", "kv/lin",
      "kv/client", "apps/kv")
# the verifier: the solver core, the aux boundary, the extractor and the
# protocol suites
SOLVER = tuple(f"verify/{m}" for m in (
    "__init__", "formula", "futils", "typer", "printer", "qilog", "lia",
    "simplify", "congruence", "quantifiers", "matching", "tactics",
    "solver", "venn", "cl", "tr", "vc", "verifier", "auxmethod",
    "extract", "protocols"))


def _port_files():
    files = sorted((REPO / "round_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert (REPO / "round_tpu_torch/native/sat.cpp").exists()
    for want in ("round_tpu_torch/engine/fast.py", "round_tpu_torch/ops/fused.py",
                 "round_tpu_torch/bench.py", "round_tpu_torch/apps/ladder.py",
                 "round_tpu_torch/spec/check.py",
                 "round_tpu_torch/tools/bisect.py",
                 "round_tpu_torch/parallel/mesh.py",
                 "round_tpu_torch/parallel/ici.py",
                 "round_tpu_torch/models/tpc.py",
                 "round_tpu_torch/models/erb.py",
                 "round_tpu_torch/models/lattice.py",
                 "round_tpu_torch/models/epsilon.py",
                 "round_tpu_torch/models/lastvoting_variants.py",
                 "round_tpu_torch/models/lastvoting_event.py",
                 "round_tpu_torch/models/tpc_event.py",
                 "round_tpu_torch/engine/epsfast.py",
                 "round_tpu_torch/ops/detsum.py",
                 "round_tpu_torch/models/kset.py",
                 "round_tpu_torch/models/failure_detector.py",
                 "round_tpu_torch/models/theta.py",
                 "round_tpu_torch/models/pbft.py",
                 "round_tpu_torch/models/mutex.py",
                 "round_tpu_torch/models/gameoflife.py",
                 "round_tpu_torch/utils/byzantine.py",
                 "round_tpu_torch/obs/__init__.py",
                 "round_tpu_torch/obs/metrics.py",
                 "round_tpu_torch/obs/trace.py",
                 "round_tpu_torch/apps/selector.py",
                 "round_tpu_torch/byz/__init__.py",
                 "round_tpu_torch/byz/lies.py",
                 "round_tpu_torch/byz/adversary.py",
                 "round_tpu_torch/fuzz/__init__.py",
                 "round_tpu_torch/fuzz/genome.py",
                 "round_tpu_torch/fuzz/objectives.py",
                 "round_tpu_torch/fuzz/search.py",
                 "round_tpu_torch/fuzz/minimize.py",
                 *(f"round_tpu_torch/runtime/{m}.py" for m in RUNTIME),
                 "round_tpu_torch/apps/perftest.py",
                 "round_tpu_torch/apps/dynamic_membership.py",
                 *(f"round_tpu_torch/apps/{m}.py" for m in HOST_APPS),
                 *(f"round_tpu_torch/{m}.py" for m in VERIFY),
                 *(f"round_tpu_torch/{m}.py" for m in KV),
                 *(f"round_tpu_torch/{m}.py" for m in SOLVER),
                 "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_forbidden_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import round_tpu_torch.engine.fast, round_tpu_torch.bench, "
        "round_tpu_torch.engine.executor, round_tpu_torch.interop, "
        "round_tpu_torch.apps.ladder, round_tpu_torch.spec, "
        "round_tpu_torch.tools.bisect, round_tpu_torch.parallel.mesh, "
        "round_tpu_torch.parallel.ici, round_tpu_torch.models.tpc, "
        "round_tpu_torch.models.erb, round_tpu_torch.models.lattice, "
        "round_tpu_torch.models.epsilon, round_tpu_torch.engine.epsfast, "
        "round_tpu_torch.models.lastvoting_variants, "
        "round_tpu_torch.models.lastvoting_event, "
        "round_tpu_torch.models.tpc_event, round_tpu_torch.ops.detsum, "
        "round_tpu_torch.byz, round_tpu_torch.fuzz.minimize, "
        "round_tpu_torch.fuzz.objectives, round_tpu_torch.utils.byzantine, "
        + "".join(f"round_tpu_torch.runtime.{m}, " for m in RUNTIME[1:]) +
        "round_tpu_torch.runtime, round_tpu_torch.apps.perftest, "
        "round_tpu_torch.apps.dynamic_membership, "
        + "".join(f"round_tpu_torch.apps.{m}, " for m in HOST_APPS)
        + "".join("round_tpu_torch.{}, ".format(m.replace("/", "."))
                  for m in VERIFY + KV + SOLVER) +
        "sys; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'round_tpu')); assert not bad, bad"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_transport_builds_from_the_ports_own_source():
    """The native transport the port loads is built from
    round_tpu_torch/native/transport.cpp into round_tpu_torch/_build/,
    never from or into round_tpu/native/."""
    from round_tpu_torch.runtime import transport

    assert Path(transport._NATIVE_SRC) == \
        REPO / "round_tpu_torch/native/transport.cpp"
    assert Path(transport._NATIVE_SO) == \
        REPO / "round_tpu_torch/_build/libroundnet.so"


def test_solver_builds_and_runs_without_touching_round_tpu(tmp_path):
    """The port's rtsat is compiled from round_tpu_torch/native/sat.cpp by
    g++ (never by make in round_tpu/native/), and neither that build nor a
    solve nor an extraction writes anything under round_tpu/ or loads
    jax: an audit hook in a fresh process sees every file opened for
    writing, every rename and every process started."""
    code = f"""
import os, sys
events = []
def hook(name, args):
    if name == "open" and args[1] not in (None, "r", "rb") and \\
            isinstance(args[0], (str, bytes, os.PathLike)):
        events.append(("write", os.fspath(args[0])))
    elif name in ("os.rename", "os.replace"):
        events.append(("rename", os.fspath(args[1])))
    elif name == "subprocess.Popen":
        events.append(("run", " ".join(map(os.fsdecode, args[1]))))
sys.addaudithook(hook)
from round_tpu_torch.verify import solver
solver._BUILD_DIR = {str(tmp_path)!r}
solver._SAT_EXE = os.path.join(solver._BUILD_DIR, "rtsat")
from round_tpu_torch.verify.formula import And, Gt, Lt, IntLit, Variable, Int
x = Variable("x", Int)
assert solver.solve_ground(And(Gt(x, IntLit(1)), Lt(x, IntLit(0)))) == "unsat"
assert solver.solve_ground(Gt(x, IntLit(1))) == "sat"
from round_tpu_torch.verify.protocols import otr_extracted_tr
otr_extracted_tr(device="cpu")
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'round_tpu'))
assert not bad, bad
print(repr(events))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    events = eval(out.stdout.strip().splitlines()[-1])  # noqa: S307
    runs = [e[1] for e in events if e[0] == "run"]
    assert any(r.startswith("g++ ") and r.endswith(
        str(REPO / "round_tpu_torch/native/sat.cpp")) for r in runs), runs
    assert not any(r.split()[0] == "make" for r in runs), runs
    theirs = str(REPO / "round_tpu") + os.sep
    written = [e[1] for e in events if e[0] in ("write", "rename")]
    assert written and not [w for w in written
                            if os.path.abspath(w).startswith(theirs)], written


def test_solver_builds_from_the_ports_own_source():
    from round_tpu_torch.verify import solver

    assert Path(solver._SAT_SRC) == REPO / "round_tpu_torch/native/sat.cpp"
    assert Path(solver._SAT_EXE) == REPO / "round_tpu_torch/_build/rtsat"
