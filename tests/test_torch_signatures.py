"""The signature audit: the port's public surface against round_tpu's.

For every round_tpu module under runtime/, kv/, rv/, snap/, verify/,
analysis/ and apps/ that has a port counterpart of the same path, each
public top-level function and each public class's ``__init__`` must take
round_tpu's parameter names with round_tpu's defaults.  The port may add
parameters (``device`` is the usual one).  Three kinds of difference are
allowed, each named: round_tpu's TPU lowering knobs, which the port drops
with the TPU family; and the divergences that ROADMAP.md's list states,
one allowlist entry each.  The audit reads both files' source (ast), so
it imports neither.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRS = ("runtime", "kv", "rv", "snap", "verify", "analysis", "apps")

#: round_tpu's TPU lowering knobs (ROADMAP.md, "TPU lowering knobs ... are
#: dropped"): a parameter of these names may be absent from the port
TPU_KNOBS = frozenset({"sb", "interpret", "variant", "ring_stride",
                       "other_axes"})

#: (port file, surface, what differs) → the divergence ROADMAP.md states
ALLOWED = {
    ("round_tpu_torch/kv/reads.py", "as_row", "missing"):
        "kv/reads.py::as_row, unused in round_tpu, is not carried",
    ("round_tpu_torch/apps/ladder.py", "rung_epsilon", "f"):
        "rung_epsilon(f=None) means max(1, n*100 // 1024)",
    ("round_tpu_torch/apps/ladder.py", "run_ladder", "budget_s"):
        "no run_ladder(budget_s=): no per-rung crash isolation",
    ("round_tpu_torch/analysis/tracerules.py", "tpu_lowerability",
     "missing"):
        "the tpu-lowerability family is not carried",
    ("round_tpu_torch/analysis/fixtures.py", "IntReduceOnTpu.__init__",
     "missing"):
        "the tpu-lowerability family's fixture is not carried",
}


def _params(fn):
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + \
        [ast.unparse(x) for x in a.defaults]
    out = [(p.arg, d) for p, d in zip(pos, defaults)]
    out += [(p.arg, None if d is None else ast.unparse(d))
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.vararg:
        out.append(("*" + a.vararg.arg, None))
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, None))
    return out


def _surface(path):
    """{name: [(param, default source)]} of the public top-level functions
    and public classes' __init__ of one file."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) \
                        and item.name == "__init__":
                    out[f"{node.name}.__init__"] = _params(item)
    return out


def _pairs():
    out = []
    for d in DIRS:
        for root, dirs, files in os.walk(os.path.join(REPO, "round_tpu", d)):
            dirs[:] = sorted(x for x in dirs if x != "__pycache__")
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                theirs = os.path.relpath(os.path.join(root, f), REPO)
                ours = theirs.replace("round_tpu/", "round_tpu_torch/", 1)
                if os.path.exists(os.path.join(REPO, ours)):
                    out.append((theirs, ours))
    return out


PAIRS = _pairs()


def _differences(theirs, ours):
    mine = _surface(ours)
    out = []
    for name, params in _surface(theirs).items():
        if name not in mine:
            out.append((ours, name, "missing"))
            continue
        got = dict(mine[name])
        for p, default in params:
            if p in TPU_KNOBS and p not in got:
                continue
            if p not in got or got[p] != default:
                out.append((ours, name, p))
    return out


def test_every_directory_has_pairs():
    assert {t.split("/")[1] for t, _ in PAIRS} == set(DIRS)
    assert len(PAIRS) > 80


@pytest.mark.parametrize("theirs,ours", PAIRS,
                         ids=[o for _t, o in PAIRS])
def test_port_surface_keeps_round_tpus_parameters(theirs, ours):
    undeclared = [d for d in _differences(theirs, ours) if d not in ALLOWED]
    assert not undeclared, (
        "parameters or defaults of round_tpu's that the port changed "
        f"without a stated divergence: {undeclared}")


def test_every_allowlist_entry_is_still_a_difference():
    found = {d for theirs, ours in PAIRS for d in _differences(theirs, ours)}
    assert set(ALLOWED) <= found, set(ALLOWED) - found
