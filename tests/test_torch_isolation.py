"""The port stands alone: round_tpu_torch and chip_smoke.py import no jax,
no flax and nothing of round_tpu (only the tests import both packages)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "round_tpu")


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
    for want in ("round_tpu_torch/engine/fast.py", "round_tpu_torch/ops/fused.py",
                 "round_tpu_torch/bench.py", "round_tpu_torch/apps/ladder.py",
                 "round_tpu_torch/spec/check.py",
                 "round_tpu_torch/tools/bisect.py",
                 "round_tpu_torch/parallel/mesh.py",
                 "round_tpu_torch/parallel/ici.py",
                 "round_tpu_torch/models/tpc.py",
                 "round_tpu_torch/models/erb.py",
                 "round_tpu_torch/models/lattice.py", "chip_smoke.py"):
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
        "round_tpu_torch.models.erb, round_tpu_torch.models.lattice, sys; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'round_tpu')); assert not bad, bad"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
