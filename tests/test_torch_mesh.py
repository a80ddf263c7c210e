"""Port parity: the sharded engines (round_tpu_torch/parallel/mesh.py) on
meshes of CPU devices, mirroring tests/test_mesh.py.

Every sharded run is held bit for bit (tolerance 0) against the port's
single-device runner and against round_tpu's output on the same numpy
inputs (round_tpu's fast runners in hash mode with the Pallas exchange in
interpret mode, and its own proc-sharded run on the 8-device CPU mesh), for
all five families, both exchanges and both loop forms."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import simulate as jsimulate
from round_tpu.models.common import consensus_io as jconsensus_io
from round_tpu.models.otr import OTR as JOTR
from round_tpu.ops import fused as jfused
from round_tpu.parallel import ici as jici
from round_tpu.parallel import mesh as jmesh
from round_tpu_torch import interop
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.engine.executor import run_instance, simulate
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.models.otr import OTR
from round_tpu_torch.ops import fused as tfused
from round_tpu_torch.parallel import ici as tici
from round_tpu_torch.parallel import mesh as tmesh
from round_tpu_torch.parallel.mesh import P, PROC_AXIS, SCENARIO_AXIS

CPU = torch.device("cpu")
N, S, ROUNDS = 16, 8, 6
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
STATE = {
    "hist": (interop.otr_state_from_numpy,
             ("x", "decided", "decision", "after")),
    "benor": (interop.benor_state_from_numpy,
              ("x", "can_decide", "vote", "decided", "decision")),
    "tpc": (interop.tpc_state_from_numpy,
            ("coord", "vote", "decision", "decided")),
    "erb": (interop.erb_state_from_numpy,
            ("x_val", "x_def", "delivered", "delivery")),
    "lattice": (interop.lattice_state_from_numpy,
                ("active", "proposed", "decided", "decision")),
}


def _cpu_mesh(k, proc_shards):
    return tmesh.make_mesh(k, proc_shards=proc_shards, devices=[CPU] * k)


def _port_mix(mix):
    return interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device="cpu")


def _port_state(family, jstate):
    from_numpy, fields = STATE[family]
    return from_numpy({k: np.asarray(getattr(jstate, k)) for k in fields},
                      device="cpu")


def _jax_single(family, state0, mix):
    if family == "hist":
        return jfast.run_hist(jfast.OtrHist(n_values=4, after_decision=2),
                              state0, lambda s: s.decided, mix, ROUNDS,
                              mode="hash", interpret=True)
    if family == "benor":
        return jfast.run_hist(jfast.BenOrHist(), state0, lambda s: s.decided,
                              mix, ROUNDS, mode="hash", interpret=True)
    if family == "tpc":
        return jfast.run_tpc_fast(state0, mix, 3, mode="hash", interpret=True)
    if family == "erb":
        return jfast.run_erb_fast(state0, mix, ROUNDS, 8, mode="hash",
                                  interpret=True)
    return jfast.run_lattice_fast(state0, mix, ROUNDS)


@functools.lru_cache(maxsize=None)
def _case(family):
    """round_tpu's own inputs of the family (its _family_runner), its
    single-device output as numpy, and the port's copies of the inputs."""
    state0, mix, _ = jici._family_runner(family, N, S, ROUNDS,
                                         jax.random.PRNGKey(3))
    want = _jax_single(family, state0, mix)
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(want)]
    return _port_state(family, state0), _port_mix(mix), want


def _port_run(family):
    return tici._family_runner(family, N, S, ROUNDS, torch.Generator(),
                               CPU)[2]


def _assert_leaves(got, want):
    leaves = torch.utils._pytree.tree_leaves(got)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "straight"])
@pytest.mark.parametrize("exchange", ["collective", "ici"])
@pytest.mark.parametrize("family", tici.FAMILIES)
def test_family_proc_sharded_matches_single_device_and_jax(
        family, exchange, pipelined):
    state0, mix, want = _case(family)
    got = _port_run(family)(state0, mix, _cpu_mesh(8, 4), exchange, pipelined)
    _assert_leaves(got, want)
    single = tici.single_device_run(family, state0, mix, ROUNDS)
    assert tici._trees_equal(got, single)
    assert bool(got[1].any())  # some lane exited


@pytest.mark.parametrize("proc_shards", [2, 4, 8])
def test_hist_proc_sharded_otr_matches_jax_sharded(proc_shards):
    """OTR at every proc factorization of 8 devices, against round_tpu's
    own proc-sharded run on its 8-device CPU mesh."""
    state0, mix, _ = jici._family_runner("hist", N, S, ROUNDS,
                                         jax.random.PRNGKey(3))
    want = jmesh.run_hist_proc_sharded(
        jfast.OtrHist(n_values=4, after_decision=2), state0, mix, ROUNDS,
        jmesh.make_mesh(8, proc_shards=proc_shards))
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(want)]
    tstate0, tmix = _port_state("hist", state0), _port_mix(mix)
    for exchange in ("collective", "ici"):
        got = tmesh.run_hist_proc_sharded(
            tfast.OtrHist(n_values=4, after_decision=2), tstate0, tmix,
            ROUNDS, _cpu_mesh(8, proc_shards), exchange=exchange)
        _assert_leaves(got, want)
    assert bool(got[0].decided.any())


def test_hist_scan_pipelined_equals_straight():
    """hist_scan's two loop forms on one device: the carried block is a
    function of the round alone, so only when it is computed moves."""
    state0, mix, want = _case("hist")
    rnd = tfast.OtrHist(n_values=4, after_decision=2)
    jg = torch.arange(N, dtype=torch.int32)
    blocks_made = []

    def ho_fn(r):
        blocks_made.append(r)
        return tmesh._ho_block(mix, r, jg, N)

    def counts_fn(state, k, done, r, ho=None):
        if ho is None:
            ho = tmesh._ho_block(mix, r, jg, N)
        from round_tpu_torch.ops.exchange import hist_code_counts, hist_pack

        return hist_code_counts(hist_pack(rnd.payload(state, k), ~done), ho,
                                rnd.num_values)

    straight = tfast.hist_scan(rnd, state0, lambda s: s.decided, ROUNDS, N,
                               counts_fn)
    piped = tfast.hist_scan(rnd, state0, lambda s: s.decided, ROUNDS, N,
                            counts_fn, ho_fn=ho_fn)
    assert tici._trees_equal(straight, piped)
    _assert_leaves(piped, want)
    assert blocks_made == list(range(ROUNDS + 1))  # round r+1's before r's update


def test_hist_scan_passes_lane_ids():
    """needs_lane_ids rounds get the caller's global ids, or arange."""
    seen = []

    class Probe(tfast.HistRound):
        num_values = 2
        needs_lane_ids = True

        def update_counts(self, state, counts, size, r, n, k=0, coin=None,
                          lane_ids=None):
            seen.append(lane_ids)
            return state, torch.zeros_like(size, dtype=torch.bool)

    state0 = torch.zeros((2, 3), dtype=torch.bool)
    counts = lambda *a: torch.zeros((2, 2, 3), dtype=torch.int32)  # noqa: E731
    tfast.hist_scan(Probe(), state0, lambda s: s, 1, 6, counts)
    ids = torch.tensor([3, 4, 5], dtype=torch.int32)
    tfast.hist_scan(Probe(), state0, lambda s: s, 1, 6, counts, lane_ids=ids)
    assert torch.equal(seen[0], torch.arange(3, dtype=torch.int32))
    assert seen[1] is ids
    assert tfast.TpcHist.no_exchange_subrounds == (0,)
    assert tfast.TpcHist.needs_lane_ids and not tfast.OtrHist.needs_lane_ids


def test_ho_block_is_a_row_slice_of_jax_ho_link_mask():
    mix = jfast.standard_mix(jax.random.PRNGKey(3), 6, N, p_drop=0.3)
    tmix = _port_mix(mix)
    for r in (0, 3, 7):
        dense = np.asarray(jfused.ho_link_mask(*_jax_round(mix, r)))
        for lo, hi in ((0, N // 2), (N // 2, N), (5, 6)):
            jg = torch.arange(lo, hi, dtype=torch.int32)
            block = tmesh._ho_block(tmix, r, jg, N)
            assert block.dtype == torch.bool
            np.testing.assert_array_equal(block.numpy(), dense[:, lo:hi, :])


def _jax_round(mix, r):
    colmask, side_r, p8, salt0, salt1r = jfast.round_params(mix, r)
    return colmask, side_r, salt0, salt1r, p8


def test_ho_block_slabs_equal_the_dense_formula(monkeypatch):
    """A batch larger than one slab is hashed slab by slab: same bits."""
    from round_tpu_torch.ops import exchange

    mix = _port_mix(jfast.standard_mix(jax.random.PRNGKey(5), 7, N,
                                       p_drop=0.3))
    jg = torch.arange(4, 12, dtype=torch.int32)
    whole = tmesh._ho_block(mix, 2, jg, N)
    monkeypatch.setattr(tfused, "_PLAIN_ELEMS", 2 * 8 * N)  # 2 rows a slab
    assert [s.stop - s.start for s in exchange._slabs(7, 8 * N)] == [2, 2, 2, 1]
    assert torch.equal(tmesh._ho_block(mix, 2, jg, N), whole)
    oh = torch.rand((7, 3, N)) < 0.5
    counts = exchange.block_counts(oh, whole)
    want = (oh[:, :, None, :] & whole[:, None, :, :]).sum(-1).to(torch.int32)
    assert counts.dtype == torch.int32 and torch.equal(counts, want)


@pytest.mark.parametrize("mode", ["hash", "hw"])
def test_sharded_hist_loop_matches_hist_loop(mode):
    k, V = 4, 8
    mix = _port_mix(jfast.standard_mix(jax.random.PRNGKey(11), 2 * k, N,
                                       p_drop=0.15, f=3, crash_round=1))
    x0 = (torch.arange(N, dtype=torch.int32) % V).expand(2 * k, N).contiguous()
    algo = tfused.OtrLoop(num_values=V, after_decision=2)
    sharded = tmesh.sharded_hist_loop(
        algo, x0, mix, ROUNDS, tmesh.Mesh.line([CPU] * k, SCENARIO_AXIS),
        mode=mode)
    single = tfused.hist_loop(algo, x0, *tfast._mix_args(mix), rounds=ROUNDS,
                              mode=mode)
    assert tici._trees_equal(sharded, single)
    assert int(sharded[0][1].sum()) > 0  # something decided


def test_sharded_hist_loop_matches_jax():
    k, V = 4, 8
    mix = jfast.standard_mix(jax.random.PRNGKey(11), 2 * k, N, p_drop=0.15,
                             f=3, crash_round=1)
    x0 = np.tile(np.arange(N, dtype=np.int32) % V, (2 * k, 1))
    want = jfused.hist_loop(
        jfused.OtrLoop(num_values=V, after_decision=2), jnp.asarray(x0),
        mix.crashed, mix.side, mix.crash_round, mix.heal_round,
        mix.rotate_down, mix.p8, mix.salt0, mix.salt1, rounds=ROUNDS,
        mode="hash", interpret=True)
    got = tmesh.sharded_hist_loop(
        tfused.OtrLoop(num_values=V, after_decision=2), torch.as_tensor(x0),
        _port_mix(mix), ROUNDS, _cpu_mesh(8, 2), mode="hash")
    leaves = torch.utils._pytree.tree_leaves(got)
    for g, w in zip(leaves, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("proc_shards", [1, 2, 4])
def test_sharded_simulate_matches_simulate(proc_shards):
    """The general engine sharded over (scenario × proc) equals the port's
    simulate on the same key, under a sampler that draws from the key."""
    n, phases = 8, 4
    algo = OTR()
    sampler = tscen.omission(n, 0.2, device="cpu")
    init = ((torch.arange(n, dtype=torch.int32) * 7) % 4).expand(
        S, n).contiguous()
    io = consensus_io(init)
    ref = simulate(algo, io, n, (11, 5), sampler, phases, n_scenarios=S,
                   io_batched=True, device="cpu")
    state, done, decided_round = tmesh.sharded_simulate(
        algo, io, n, (11, 5), sampler, phases, S, _cpu_mesh(8, proc_shards))
    assert tici._trees_equal((state, done, decided_round),
                             (ref.state, ref.done, ref.decided_round))
    assert bool(state.decided.any()) and not bool(state.decided.all())


def test_sharded_simulate_matches_jax_on_a_keyless_sampler():
    """scenarios.full ignores the key, so round_tpu's simulate gives the
    same values whatever its per-scenario keys are."""
    n, phases = 8, 3
    init = np.tile((np.arange(n, dtype=np.int32) * 7) % 4, (S, 1))
    want = jsimulate(JOTR(), jconsensus_io(init), n, jax.random.PRNGKey(0),
                     jscen.full(n), max_phases=phases, n_scenarios=S,
                     io_batched=True)
    state, done, decided_round = tmesh.sharded_simulate(
        OTR(), consensus_io(torch.as_tensor(init)), n, (0, 0),
        tscen.full(n, device="cpu"), phases, S, _cpu_mesh(8, 2))
    for name in ("x", "decided", "decision", "after"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(want.state, name)))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(decided_round.numpy(),
                                  np.asarray(want.decided_round))


def test_sharded_keyed_parity():
    n = 8
    init = torch.arange(n, dtype=torch.int32) % 3

    def one(key):
        res = run_instance(OTR(), consensus_io(init), n, key,
                           tscen.omission(n, 0.3, device="cpu"), 4,
                           device="cpu")
        return res.state.decided, res.decided_round, res.state.decision

    keys = torch.tensor([[s * 7 + 1, 9] for s in range(8)])
    run, sharded, parity = tmesh.sharded_keyed_parity(one, keys, 4,
                                                      devices=[CPU] * 4)
    assert parity and sharded[0].shape == (8, n)
    assert tici._trees_equal(run(keys), sharded)
    with pytest.raises(ValueError, match="8 keys over 3"):
        tmesh.sharded_keyed_parity(one, keys, 3, devices=[CPU] * 3)


def test_shard_map_splits_and_joins_by_spec():
    mesh = _cpu_mesh(4, 2)
    x = torch.arange(4 * 6).reshape(4, 6)
    seen = {}

    def body(x_l, y_l):
        pos = (tmesh.axis_index(SCENARIO_AXIS), tmesh.axis_index(PROC_AXIS))
        seen[pos] = (tuple(x_l.shape), tuple(y_l.shape),
                     tmesh.shard_device())
        return x_l * 10, (y_l.sum()[None], x_l[:, :1])

    y = torch.arange(4.0)
    out, (sums, col) = tmesh.shard_map(
        body, mesh, in_specs=(P(SCENARIO_AXIS, PROC_AXIS), P(SCENARIO_AXIS)),
        out_specs=(P(SCENARIO_AXIS, PROC_AXIS),
                   (P(SCENARIO_AXIS), P(SCENARIO_AXIS))))(x, y)
    assert torch.equal(out, x * 10)
    assert sorted(seen) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(v == ((2, 3), (2,), CPU) for v in seen.values())
    # outputs replicated along an axis come from its first shard
    assert torch.equal(sums, torch.tensor([1.0, 5.0]))
    assert torch.equal(col, x[:, :1])
    with pytest.raises(RuntimeError, match="inside shard_map"):
        tmesh.axis_index(PROC_AXIS)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_map(lambda a: a, mesh, in_specs=(P(None, PROC_AXIS),),
                        out_specs=P(None, PROC_AXIS))(torch.zeros(2, 3))


def test_all_gather_is_cat_and_is_counted():
    mesh = _cpu_mesh(4, 4)
    x = torch.arange(3 * 8, dtype=torch.int32).reshape(3, 8)
    tmesh.reset_collective()
    out = tmesh.shard_map(
        lambda x_l: tmesh.all_gather(x_l, PROC_AXIS, dim=1)[None], mesh,
        in_specs=(P(None, PROC_AXIS),),
        out_specs=P(PROC_AXIS))(x)
    assert out.shape == (4, 3, 8) and all(torch.equal(o, x) for o in out)
    assert tmesh.COLLECTIVE["calls"] == 4
    assert tmesh.COLLECTIVE["bytes"] == 4 * x.numel() * 4


def test_collectives_under_thread_pressure():
    """More shards than cores, a short switch interval, many rendezvous
    back to back: every gather is right and every call is counted (a lost
    update of the shared counters would show)."""
    import sys

    p, calls = 16, 100
    x = torch.arange(p, dtype=torch.int32).reshape(1, p)

    def body(x_l):
        ok = torch.ones((), dtype=torch.bool)
        for i in range(calls):
            lib = tmesh.all_gather(x_l + i, "ring", dim=1)
            ring = tici.ring_exchange(x_l + i, axis="ring", p=p)
            ok = ok & torch.equal(lib, x + i) & torch.equal(ring, x + i)
        return ok[None]

    result = []

    def call():
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            tmesh.reset_collective()
            result.append(tmesh.shard_map(
                body, tmesh.Mesh.line([CPU] * p, "ring"),
                in_specs=(P(None, "ring"),), out_specs=P("ring"))(x))
        finally:
            sys.setswitchinterval(old)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the collectives hung"
    assert bool(result[0].all())
    assert tmesh.COLLECTIVE["calls"] == p * calls
    assert tmesh.COLLECTIVE["bytes"] == p * calls * p * 4


def test_a_shard_that_raises_surfaces_as_one_exception():
    """The failing shard's own exception reaches the caller; the peers it
    left at a rendezvous are released, not hung."""
    mesh = _cpu_mesh(4, 4)

    def body(x_l):
        if tmesh.axis_index(PROC_AXIS) == 2:
            raise KeyError("shard 2 failed")
        return tmesh.all_gather(x_l, PROC_AXIS)

    done = []

    def call():
        with pytest.raises(KeyError, match="shard 2 failed"):
            tmesh.shard_map(body, mesh, in_specs=(P(None, PROC_AXIS),),
                            out_specs=P(None, PROC_AXIS))(torch.zeros(2, 8))
        done.append(True)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=60)
    assert done == [True], "shard_map hung after a shard raised"


def test_make_mesh_raises_on_too_few_devices():
    with pytest.raises(ValueError, match="want 8 devices, have 4"):
        tmesh.make_mesh(8, proc_shards=2, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.make_mesh(6, proc_shards=4, devices=[CPU] * 6)
    mesh = tmesh.make_mesh(proc_shards=2, devices=["cpu"] * 6)
    assert mesh.shape == {SCENARIO_AXIS: 3, PROC_AXIS: 2}
    assert mesh.devices.shape == (3, 2) and mesh.devices[2, 1] == CPU
    with pytest.raises(ValueError, match="do not split over the mesh"):
        state0, mix, _ = _case("hist")
        tmesh.run_hist_proc_sharded(
            tfast.OtrHist(4), state0, mix, 2, _cpu_mesh(6, 3))
    with pytest.raises(ValueError, match="unknown exchange"):
        tmesh._resolve_exchange("nccl", None)
    assert tmesh._resolve_exchange("ici", None) == ("ici", True)
    assert tmesh._resolve_exchange("collective", None) == ("collective", False)


def test_mesh_defaults_to_the_cards():
    """No device list means every visible CUDA card: with none, the sharded
    entry points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(4, proc_shards=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.dryrun(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tici.family_parity("hist")


def test_dryrun_on_cpu_devices(capsys):
    tmesh.dryrun(8, devices=[CPU] * 8)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all(
        ln.startswith("dryrun_multichip") and " ok" in ln for ln in lines)
    with pytest.raises(RuntimeError, match="wants 8 devices, have 2"):
        tmesh.dryrun(8, devices=[CPU] * 2)
    with pytest.raises(AssertionError, match="boom"):
        tmesh._assert_tree_parity((torch.zeros(2),), (torch.ones(2),), "boom")
