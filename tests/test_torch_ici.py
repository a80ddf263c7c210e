"""Port parity: the hand-written exchange (round_tpu_torch/parallel/ici.py)
on meshes of CPU devices, mirroring tests/test_ici.py.

On CPU shards ``ring_exchange`` takes its plain version, so these tests
hold what surrounds the kernel: the rendezvous, the column order, the
feature-dim flattening, the rows of a two-axis mesh, the byte accounting
against round_tpu's and the status line.  The kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from round_tpu.parallel import ici as jici
from round_tpu_torch.ops import fused as tfused
from round_tpu_torch.parallel import ici as tici
from round_tpu_torch.parallel import mesh as tmesh
from round_tpu_torch.parallel.mesh import P, PROC_AXIS, SCENARIO_AXIS

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _ring_outputs(x, p, fn):
    """fn's output on every shard of a p-ring over the columns of x."""
    ring = tmesh.Mesh.line([CPU] * p, "ring")
    return tmesh.shard_map(lambda x_l: fn(x_l)[None], ring,
                           in_specs=(P(None, "ring"),),
                           out_specs=P("ring"))(x)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("dtype,shape", [
    (torch.int32, (4, 6)), (torch.int32, (7, 5)), (torch.int32, (1, 1)),
    (torch.int8, (5, 44)), (torch.int8, (3, 7)),
])
def test_ring_exchange_is_the_tiled_all_gather(p, dtype, shape):
    """Every shard's output is the chunks side by side in axis order: the
    column order of all_gather(dim=1), for int32 codes and int8 planes,
    aligned and odd widths."""
    rng = np.random.default_rng(p * 100 + shape[1])
    x = torch.as_tensor(rng.integers(-100, 100, (shape[0], p * shape[1]))
                        ).to(dtype)
    before = dict(tfused.LAUNCHES)
    got = _ring_outputs(
        x, p, lambda x_l: tici.ring_exchange(x_l, axis="ring", p=p))
    assert got.shape == (p,) + tuple(x.shape) and got.dtype == dtype
    assert all(torch.equal(g, x) for g in got)
    gathered = _ring_outputs(
        x, p, lambda x_l: tmesh.all_gather(x_l, "ring", dim=1))
    assert torch.equal(got, gathered)
    assert tfused.LAUNCHES == before  # CPU shards: the plain version


def test_ring_exchange_plain_is_cat():
    chunks = [torch.full((2, 3), d, dtype=torch.int32) for d in range(4)]
    outs = tici._ring_exchange_plain(chunks)
    assert len(outs) == 4
    for out in outs:
        assert torch.equal(out, torch.cat(chunks, dim=1))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_make_ring_gather_flattens_feature_dims(p):
    """[S_l, n_l, m + 1] int8 planes ride flattened into the columns and
    come back as [S_l, p * n_l, m + 1]; p == 1 is the identity."""
    rng = np.random.default_rng(p)
    x = torch.as_tensor(rng.integers(0, 2, (5, p * 4, 11))).to(torch.int8)
    if p == 1:
        assert tici.make_ring_gather("ring", 1)(x) is x
        return
    got = _ring_outputs(x, p, tici.make_ring_gather("ring", p))
    assert got.shape == (p, 5, p * 4, 11)
    assert all(torch.equal(g, x) for g in got)


def test_ring_stays_inside_its_scenario_row():
    """On the (scenario × proc) mesh the exchange runs among the shards of
    one scenario row, exactly like the all_gather it replaces."""
    mesh = tmesh.make_mesh(4, proc_shards=2, devices=[CPU] * 4)
    x = torch.arange(12 * 20, dtype=torch.int32).reshape(12, 20)
    spec = P(SCENARIO_AXIS, PROC_AXIS)
    got = tmesh.shard_map(
        lambda x_l: tici.ring_exchange(x_l, axis=PROC_AXIS, p=2), mesh,
        in_specs=(spec,), out_specs=spec)(x)
    assert torch.equal(got, torch.cat([x, x], dim=1))


def test_ring_exchange_refuses_what_the_kernel_does_not_take():
    ring = tmesh.Mesh.line([CPU] * 2, "ring")

    def run(fn, x):
        return tmesh.shard_map(fn, ring, in_specs=(P(None, "ring"),),
                               out_specs=P(None, "ring"))(x)

    with pytest.raises(ValueError, match="int32 or int8"):
        run(lambda x_l: tici.ring_exchange(x_l, axis="ring", p=2),
            torch.zeros((2, 4), dtype=torch.float32))
    with pytest.raises(ValueError, match="int32 or int8"):
        run(lambda x_l: tici.ring_exchange(x_l[0], axis="ring", p=2),
            torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="p=4 on an axis of 2"):
        run(lambda x_l: tici.ring_exchange(x_l, axis="ring", p=4),
            torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="inside shard_map"):
        tici.ring_exchange(torch.zeros((2, 4), dtype=torch.int32),
                           axis="ring", p=2)


def test_ring_launch_groups_neighbours_on_a_device():
    """Shards of one device share a launch; a device that appears twice,
    apart, on the ring is refused."""
    def items(devices):
        return [{"x": torch.empty((1, 1), device=d)} for d in devices]

    meta = torch.device("meta")
    assert tici._device_runs(items([CPU] * 4)) == [[0, 1, 2, 3]]
    assert tici._device_runs(items([CPU, CPU, meta, meta])) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="must be neighbours"):
        tici._device_runs(items([CPU, meta, CPU, meta]))


def test_ring_bytes_per_round_matches_jax():
    for args in ((8, 4, 4, 4), (8, 4, 1, 4), (2000, 256, 4, 4),
                 (8, 32 * 11, 2, 1, 2)):
        assert tici.ring_bytes_per_round(*args) == \
            jici.ring_bytes_per_round(*args)
    assert tici.ring_bytes_per_round(8, 4, 4, 4) == 3 * 8 * 4 * 4
    assert tici.FAMILIES == jici.FAMILIES


@pytest.mark.parametrize("family", ["hist", "lattice"])
def test_exchange_bytes_report_matches_jax(family):
    """The bytes the port's all_gather moved per device and round equal
    what round_tpu reads off its compiled HLO, and so do the ici bytes, the
    ratio and the (p-1)/p gate."""
    want = jici.exchange_bytes_report(family=family)
    got = tici.exchange_bytes_report(family=family, devices=[CPU] * 8)
    for key in ("family", "n", "S", "proc_shards",
                "collective_bytes_per_round", "ici_bytes_per_round", "ratio",
                "bound", "ok"):
        assert got[key] == want[key], key
    assert got["ok"] and got["ratio"] <= got["bound"]


def test_exchange_bytes_skip_the_no_exchange_subround():
    """TPC's prepare round gathers nothing: 3 rounds, 2 exchanges of two
    tensors on each of the 8 shards."""
    got = tici.exchange_bytes_report(family="tpc", devices=[CPU] * 8)
    assert got["collective_calls"] == 8 * 2 * 2
    assert got["collective_bytes_per_round"] == 2 * 16 * (4 + 1)
    assert got["ok"]


@pytest.mark.parametrize("family", tici.FAMILIES)
def test_family_parity(family):
    assert tici.family_parity(family, n=16, S=8, proc_shards=2, rounds=6,
                              devices=[CPU] * 8)
    assert tici.family_parity(family, n=16, S=8, proc_shards=4, rounds=6,
                              pipelined=False, devices=[CPU] * 4)


def test_family_runner_refuses_unknown_family():
    with pytest.raises(ValueError, match="unknown ici family"):
        tici._family_runner("paxos", 8, 4, 2, torch.Generator(), CPU)
    with pytest.raises(ValueError, match="unknown ici family"):
        tici.single_device_run("paxos", None, None, 2)


def test_status_on_cpu_devices():
    stages = []
    out = tici.status(n=16, S=8, rounds=4, devices=[CPU] * 4,
                      stage_fn=stages.append)
    assert stages == ["ici-parity", "ici-bytes", "ici-launches"]
    assert out["ok"] and out["parity"] and out["bytes"]["ok"]
    # the ici run called no library gather; CPU shards launch no kernel
    assert out["launches"] == {"ring_exchange": 0, "all_gather_calls": 0,
                               "expected_ring_exchange": 0}
    skipped = tici.status(devices=[CPU])
    assert "skipped" in skipped and "ok" not in skipped


def test_status_cli_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "round_tpu_torch.parallel.ici", "--devices",
         "cpu,cpu,cpu,cpu", "--n", "16", "--scenarios", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ok"] and rec["devices"] == ["cpu"] * 4
    assert "PROBE_STAGE ici-parity" in out.stderr
