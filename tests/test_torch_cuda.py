"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips (it does not fail) where torch finds no CUDA
card, deciding inside the test.  On the card, chip_smoke.py is the full
check at n=1024; these are the quick per-kernel checks of K2, the three K1
instances and K3 (hash mode), K2 and K1 in hw mode, the tensor-core count
of K1 and K2 at n = 1008, in sided rounds, with receivers finishing early
and with the one-hot in device memory, the probes P1 and P2 (sizes that
are not a multiple of 4, views off a 16-byte boundary), and K4 over
shards of one card (its local kernel on both paths, the launches per
path):

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

from round_tpu_torch.engine import fast
from round_tpu_torch.ops import fused
from round_tpu_torch.parallel import ici, mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [64, 1000])
def test_hist_exchange_kernel_matches_plain(dev, n):
    S, V = 14, 8
    g = torch.Generator(device=dev).manual_seed(n)
    vals = torch.randint(0, V, (S, n), generator=g, device=dev,
                         dtype=torch.int32)
    senders = torch.rand((S, n), generator=g, device=dev) < 0.8
    rowmask = torch.rand((S, n), generator=g, device=dev) < 0.9
    side = torch.randint(0, 2, (S, n), generator=g, device=dev,
                         dtype=torch.int32)
    s0, s1 = fast._salts(g, S, 0, dev), fast._salts(g, S, 1, dev)
    p8 = torch.tensor([0, 1, 13, 64, 128, 255, 256] * 2, dtype=torch.int32,
                      device=dev)
    senders = senders & (p8 < 256)[:, None]
    for rm in (None, rowmask):
        for sd in (None, side):
            before = fused.LAUNCHES["hist_exchange"]
            got = fused._hist_exchange_cuda(vals, senders, rm, sd, s0, s1,
                                            p8, V, "hash")
            torch.cuda.synchronize()
            assert fused.LAUNCHES["hist_exchange"] == before + 1
            want = fused._hist_exchange_plain(vals, senders, rm, sd, s0, s1,
                                              p8, V, "hash")
            assert torch.equal(got, want)


@pytest.mark.parametrize("n", [64, 1000])
def test_otr_loop_kernel_matches_plain(dev, n):
    S, V, rounds = 16, 8, 8
    g = torch.Generator(device=dev).manual_seed(n)
    mix = fast.standard_mix(g, S, n, device=dev)
    mix = mix.replace(p8=torch.where(torch.arange(S, device=dev) == 5, 256,
                                     mix.p8).to(torch.int32))
    x0 = torch.randint(0, V, (n,), generator=g, device=dev,
                       dtype=torch.int32).expand(S, n).contiguous()
    args = (x0, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
            mix.rotate_down, mix.p8, mix.salt0, mix.salt1)
    algo = fused.OtrLoop(num_values=V, after_decision=2)
    got = fused._hist_loop_cuda(algo, *args, rounds, "hash")
    torch.cuda.synchronize()
    want = fused._hist_loop_plain(algo, *args, rounds, "hash")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _loop_inputs(dev, n, S, V, seed, heal_round=5):
    """standard_mix rows with the p8 grid of every drop regime (0, 1, 13,
    64, 128, 255 and the 256 blackout) laid over the drop rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mix = fast.standard_mix(g, S, n, heal_round=heal_round, device=dev)
    grid = torch.tensor([0, 1, 13, 64, 128, 255, 256], dtype=torch.int32,
                        device=dev).repeat(S // 7 + 1)[:S]
    over = torch.arange(S, device=dev) % 3 == 0
    mix = mix.replace(p8=torch.where(over, grid, mix.p8).to(torch.int32))
    x0 = torch.randint(0, V, (n,), generator=g, device=dev,
                       dtype=torch.int32).expand(S, n).contiguous()
    return (x0, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
            mix.rotate_down, mix.p8, mix.salt0, mix.salt1)


@pytest.mark.parametrize("algo,rounds", [
    (fused.FloodMinLoop(num_values=16, f=2), 6),
    (fused.FloodMinLoop(num_values=1000, f=2), 6),
    (fused.BenOrLoop(), 12),
])
@pytest.mark.parametrize("n", [64, 1000])
def test_new_loop_instances_match_plain(dev, n, algo, rounds):
    args = _loop_inputs(dev, n, 21, algo.num_values, n + rounds)
    before = fused.LAUNCHES[algo.kernel]
    got = fused._hist_loop_cuda(algo, *args, rounds, "hash")
    torch.cuda.synchronize()
    assert fused.LAUNCHES[algo.kernel] == before + 1
    want = fused._hist_loop_plain(algo, *args, rounds, "hash")
    assert len(got) == algo.n_state + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [64, 1000])
def test_lv_loop_kernel_matches_plain(dev, n):
    args = _loop_inputs(dev, n, 21, 40, n, heal_round=9)
    before = fused.LAUNCHES["lv_loop"]
    got = fused._lv_loop_cuda(*args, 20)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["lv_loop"] == before + 1
    want = fused._lv_loop_plain(*args, 20)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [64, 1000])
def test_hw_hist_exchange_kernel_matches_plain(dev, n):
    """K2 in hw mode: n=1000 is not a multiple of 16, so a Philox block
    straddles two receivers' rows."""
    S, V = 14, 8
    g = torch.Generator(device=dev).manual_seed(n + 1)
    vals = torch.randint(0, V, (S, n), generator=g, device=dev,
                         dtype=torch.int32)
    senders = torch.rand((S, n), generator=g, device=dev) < 0.8
    side = torch.randint(0, 2, (S, n), generator=g, device=dev,
                         dtype=torch.int32)
    s0, s1 = fast._salts(g, S, 0, dev), fast._salts(g, S, 1, dev)
    p8 = torch.tensor([0, 1, 13, 64, 128, 255, 256] * 2, dtype=torch.int32,
                      device=dev)
    senders = senders & (p8 < 256)[:, None]
    for sd in (None, side):
        before = fused.LAUNCHES["hist_exchange_hw"]
        got = fused._hist_exchange_cuda(vals, senders, None, sd, s0, s1, p8,
                                        V, "hw")
        torch.cuda.synchronize()
        assert fused.LAUNCHES["hist_exchange_hw"] == before + 1
        want = fused._hist_exchange_plain(vals, senders, None, sd, s0, s1,
                                          p8, V, "hw")
        assert torch.equal(got, want)


@pytest.mark.parametrize("algo,rounds", [
    (fused.OtrLoop(num_values=8, after_decision=2), 8),
    (fused.FloodMinLoop(num_values=16, f=2), 6),
    (fused.BenOrLoop(), 12),
])
@pytest.mark.parametrize("n", [64, 1000])
def test_hw_loop_instances_match_plain(dev, n, algo, rounds):
    args = _loop_inputs(dev, n, 21, algo.num_values, n + rounds + 1)
    name = algo.kernel + "_hw"
    before = fused.LAUNCHES[name]
    got = fused._hist_loop_cuda(algo, *args, rounds, "hw")
    torch.cuda.synchronize()
    assert fused.LAUNCHES[name] == before + 1
    want = fused._hist_loop_plain(algo, *args, rounds, "hw")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_probe_double_kernel_matches_plain(dev):
    x = torch.randn((128, 128), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    before = fused.LAUNCHES["probe_double"]
    got = fused.probe_double(x)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["probe_double"] == before + 1
    assert torch.equal(got.cpu(), fused.probe_double(x.cpu()))


@pytest.mark.parametrize("m", [1, 3, 5, 127, 4097, 128 * 128 + 2])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_probe_double_odd_sizes_and_offset_views(dev, m, offset):
    """P1's scalar tail (m % 4 != 0) and its scalar path (a view that
    starts 4 or 12 bytes past a 16-byte boundary)."""
    base = torch.randn((m + offset,), generator=torch.Generator(device=dev)
                       .manual_seed(m), device=dev)
    x = base[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = fused.LAUNCHES["probe_double"]
    got = fused.probe_double(x)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["probe_double"] == before + 1
    assert torch.equal(got, x * 2.0)


KAT = [  # Random123's Philox4x32-10 known-answer vectors
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def test_philox_bits_kernel_matches_plain(dev):
    seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    before = fused.LAUNCHES["philox_bits"]
    got = fused.philox_bits(seed, (128, 128))
    torch.cuda.synchronize()
    assert fused.LAUNCHES["philox_bits"] == before + 1
    assert torch.equal(got.cpu(), fused.philox_bits(seed.cpu(), (128, 128)))
    for counter, key, words in KAT:
        k = fused._i32(torch.tensor(key)).to(dev)
        got = fused.philox_bits(k, (4,), counter=counter)
        assert [w & 0xFFFFFFFF for w in got.tolist()] == list(words)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("dtype,shape", [
    (torch.int32, (64, 256)), (torch.int32, (7, 250)), (torch.int32, (1, 1)),
    (torch.int8, (64, 256 * 11)), (torch.int8, (5, 44)),
])
def test_ring_exchange_kernel_matches_plain(dev, p, dtype, shape):
    """K4 over p shards of one card, three exchanges back to back (the
    epochs), every shard's output against the plain version."""
    g = torch.Generator(device=dev).manual_seed(p + shape[1])
    x = torch.randint(-100, 100, (shape[0], p * shape[1]), generator=g,
                      device=dev, dtype=torch.int64).to(dtype)
    name = ici._LAUNCH_NAMES[dtype]
    before = fused.LAUNCHES[name]

    def body(x_l):
        return torch.stack([ici.ring_exchange(x_l + i, axis="ring", p=p)
                            for i in range(3)])[None]

    local = fused.LAUNCHES["ring_exchange_local"]
    got = mesh.shard_map(body, mesh.Mesh.line([dev] * p, "ring"),
                         in_specs=(mesh.P(None, "ring"),),
                         out_specs=mesh.P("ring"))(x)
    assert fused.LAUNCHES[name] == before + 3  # one launch for all shards
    assert fused.LAUNCHES["ring_exchange_local"] == local + 3
    chunks = list(x.chunk(p, dim=1))
    for i in range(3):
        want = ici._ring_exchange_plain([c + i for c in chunks])
        for d in range(p):
            assert torch.equal(got[d, i], want[d])


def _ring_on_card(dev, p, x, body):
    return mesh.shard_map(body, mesh.Mesh.line([dev] * p, "ring"),
                          in_specs=(mesh.P(None, "ring"),),
                          out_specs=mesh.P("ring"))(x)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("dtype,shape,path", [
    (torch.int32, (2000, 256), "bulk"),   # the sharded flagship's chunk
    (torch.int8, (8, 352), "bulk"),       # the lattice family's planes
    (torch.int32, (37, 256), "bulk"),     # rows not a multiple of a band
    (torch.int8, (5, 44), "register"),    # 44-byte rows
    (torch.int32, (7, 250), "register"),
    (torch.int8, (3, 7), "register"),
])
@pytest.mark.parametrize("offset", [False, True])
def test_ring_local_paths_match_plain(dev, p, dtype, shape, path, offset):
    """The local kernel on its bulk and register paths, and on chunks one
    element past a 16-byte boundary (the register path), against the plain
    version; the plan it took."""
    g = torch.Generator(device=dev).manual_seed(p * 1000 + shape[1])
    x = torch.randint(-100, 100, (shape[0], p * shape[1]), generator=g,
                      device=dev, dtype=torch.int64).to(dtype)
    plans = []

    def body(x_l):
        x_l = x_l.contiguous()
        if offset:
            flat = torch.empty(x_l.numel() + 1, dtype=dtype, device=dev)[1:]
            x_l = flat.view_as(x_l).copy_(x_l)
        out = ici.ring_exchange(x_l, axis="ring", p=p)
        plans.append(mesh.axis_group("ring")[1].ring.plan)
        return out[None]

    got = _ring_on_card(dev, p, x, body)
    want = ici._ring_exchange_plain(list(x.chunk(p, dim=1)))
    for d in range(p):
        assert torch.equal(got[d], want[d])
    assert plans[0].kernel == "local"
    assert plans[0].path == ("register" if offset else path)


def test_ring_local_100_exchanges_count_per_path(dev):
    """100 exchanges back to back over 4 shards of one card: 100 local
    launches, none on the peers path, every output right."""
    p, calls = 4, 100
    g = torch.Generator(device=dev).manual_seed(100)
    x = torch.randint(-2**20, 2**20, (64, p * 256), generator=g, device=dev,
                      dtype=torch.int32)
    before = dict(fused.LAUNCHES)

    def body(x_l):
        return torch.stack([ici.ring_exchange(x_l + i, axis="ring", p=p)
                            for i in range(calls)])[None]

    got = _ring_on_card(dev, p, x, body)
    assert fused.LAUNCHES["ring_exchange_local"] \
        == before["ring_exchange_local"] + calls
    assert fused.LAUNCHES["ring_exchange"] == before["ring_exchange"] + calls
    assert fused.LAUNCHES["ring_exchange_peers"] \
        == before["ring_exchange_peers"]
    chunks = list(x.chunk(p, dim=1))
    for i in range(calls):
        want = torch.cat([c + i for c in chunks], dim=1)
        for d in range(p):
            assert torch.equal(got[d, i], want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
def test_ring_exchange_on_a_2x2_mesh(dev, dtype):
    """Each ring of a 2 x 2 mesh of one card stays in its scenario row."""
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randint(-100, 100, (2 * 6, 2 * 48), generator=g, device=dev,
                      dtype=torch.int64).to(dtype)
    m = mesh.make_mesh(4, proc_shards=2, devices=[dev] * 4)
    before = fused.LAUNCHES["ring_exchange_local"]
    got = mesh.shard_map(
        lambda x_l: ici.ring_exchange(x_l, axis=mesh.PROC_AXIS, p=2), m,
        in_specs=(mesh.P(mesh.SCENARIO_AXIS, mesh.PROC_AXIS),),
        out_specs=mesh.P(mesh.SCENARIO_AXIS, mesh.PROC_AXIS))(x)
    assert torch.equal(got, torch.cat([x, x], dim=1))
    assert fused.LAUNCHES["ring_exchange_local"] == before + 2  # two rings


@pytest.mark.parametrize("family", ici.FAMILIES)
def test_sharded_family_on_one_card(dev, family):
    """Each family on a 2 x 2 mesh of one card: the kernel path equals the
    library gather and the single-device runner, and calls no gather."""
    devices = [dev] * 4
    assert ici.family_parity(family, n=32, S=8, proc_shards=2, rounds=6,
                             devices=devices)
    g = torch.Generator(device=dev).manual_seed(3)
    state0, mix, run = ici._family_runner(family, 32, 8, 6, g, dev)
    mesh.reset_collective()
    got = run(state0, mix, mesh.make_mesh(4, 2, devices), "ici", None)
    assert mesh.COLLECTIVE["calls"] == 0
    assert ici._trees_equal(got, ici.single_device_run(family, state0, mix, 6))


def _sided_inputs(dev, n, S, V, seed):
    """Every row split three ways for the whole run, the p8 grid over the
    rows, some crashes: every round is sided, most draw."""
    g = torch.Generator(device=dev).manual_seed(seed)
    args = list(_loop_inputs(dev, n, S, V, seed, heal_round=99))
    args[2] = torch.randint(0, 3, (S, n), generator=g, device=dev,
                            dtype=torch.int32)                   # side
    args[4] = torch.full((S,), 99, dtype=torch.int32, device=dev)  # heal
    args[6] = torch.tensor([0, 1, 13, 64, 128, 255, 256], dtype=torch.int32,
                           device=dev).repeat(S // 7 + 1)[:S]    # p8
    return tuple(args)


@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n", [1008, 64])
def test_hist_exchange_kernel_n1008_and_sided(dev, n, mode):
    """K2 at n = 1008 (n % 64 != 0: a padded last sender block; n % 16 == 0)
    and with three sides, against its plain version."""
    S, V = 14, 16
    g = torch.Generator(device=dev).manual_seed(n + 2)
    vals = torch.randint(-1, V + 1, (S, n), generator=g, device=dev,
                         dtype=torch.int32)
    senders = torch.rand((S, n), generator=g, device=dev) < 0.8
    rowmask = torch.rand((S, n), generator=g, device=dev) < 0.9
    side = torch.randint(0, 3, (S, n), generator=g, device=dev,
                         dtype=torch.int32)
    s0, s1 = fast._salts(g, S, 0, dev), fast._salts(g, S, 1, dev)
    p8 = torch.tensor([0, 1, 13, 64, 128, 255, 256] * 2, dtype=torch.int32,
                      device=dev)
    senders = senders & (p8 < 256)[:, None]
    for rm, sd in ((None, None), (rowmask, side), (None, side)):
        got = fused._hist_exchange_cuda(vals, senders, rm, sd, s0, s1, p8, V,
                                        mode)
        torch.cuda.synchronize()
        want = fused._hist_exchange_plain(vals, senders, rm, sd, s0, s1, p8,
                                          V, mode)
        assert torch.equal(got, want)


@pytest.mark.parametrize("algo,rounds", [
    (fused.OtrLoop(num_values=16, after_decision=2), 8),
    (fused.BenOrLoop(), 12),
])
@pytest.mark.parametrize("mode", ["hash", "hw"])
def test_loop_kernel_n1008(dev, mode, algo, rounds):
    """K1's tensor-core instances at n = 1008, every family over the p8
    grid, in both streams."""
    args = _loop_inputs(dev, 1008, 21, algo.num_values, rounds + 3)
    got = fused._hist_loop_cuda(algo, *args, rounds, mode)
    torch.cuda.synchronize()
    want = fused._hist_loop_plain(algo, *args, rounds, mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo,rounds", [
    (fused.OtrLoop(num_values=8, after_decision=2), 7),
    (fused.BenOrLoop(), 10),
])
@pytest.mark.parametrize("n", [1000, 1008])
def test_hw_loop_kernel_sided_rounds(dev, n, algo, rounds):
    """Sided hw rounds: three sides for the whole run, the p8 grid."""
    args = _sided_inputs(dev, n, 14, algo.num_values, n + 5)
    got = fused._hist_loop_cuda(algo, *args, rounds, "hw")
    torch.cuda.synchronize()
    want = fused._hist_loop_plain(algo, *args, rounds, "hw")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["hash", "hw"])
def test_otr_loop_kernel_groups_finish_early(dev, mode):
    """Scenarios whose receivers all finish in the first rounds, beside
    ones that keep running and ones that lose a few lanes early: the
    receiver list shrinks, tiles empty out, the loop exits per block."""
    n, S, V, rounds = 1024, 12, 8, 12
    g = torch.Generator(device=dev).manual_seed(11)
    mix = fast.standard_mix(g, S, n, device=dev)
    p8 = torch.tensor([0, 0, 0, 1, 200, 255] * 2, dtype=torch.int32,
                      device=dev)
    mix = mix.replace(p8=p8, heal_round=torch.zeros_like(mix.heal_round),
                      rotate_down=torch.zeros_like(mix.rotate_down))
    x0 = torch.randint(0, V, (n,), generator=g, device=dev,
                       dtype=torch.int32).expand(S, n).contiguous()
    x0[6:] = 3  # unanimous: every lane decides in round 0
    args = (x0, *fast._mix_args(mix))
    algo = fused.OtrLoop(num_values=V, after_decision=1)
    got = fused._hist_loop_cuda(algo, *args, rounds, mode)
    torch.cuda.synchronize()
    want = fused._hist_loop_plain(algo, *args, rounds, mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    done, dround = got[4], got[5]
    assert bool((done[6:9] != 0).all()) and bool((dround[6:9] == 0).all())


def test_otr_loop_kernel_onehot_in_device_memory(dev):
    """Where the one-hot does not fit in shared memory (n = 2048, V = 100)
    it lives in device memory beside the state; the kernel is the same."""
    algo = fused.OtrLoop(num_values=100, after_decision=2)
    args = _loop_inputs(dev, 2048, 4, 100, 17)
    for mode in ("hw", "hash"):
        got = fused._hist_loop_cuda(algo, *args, 4, mode)
        torch.cuda.synchronize()
        want = fused._hist_loop_plain(algo, *args, 4, mode)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _many_sided_inputs(dev, n, S, V, seed, sides):
    """`sides` sides for the first rounds, the p8 grid over the rows, x0
    with a few payloads outside [0, V)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    args = list(_loop_inputs(dev, n, S, V, seed, heal_round=3))
    args[0] = torch.randint(-1, V + 2, (S, n), generator=g, device=dev,
                            dtype=torch.int32)                   # x0
    args[2] = torch.randint(0, sides, (S, n), generator=g, device=dev,
                            dtype=torch.int32)                   # side
    args[4] = torch.full((S,), 3, dtype=torch.int32, device=dev)  # heal
    args[6] = torch.tensor([0, 1, 13, 64, 128, 255, 256], dtype=torch.int32,
                           device=dev).repeat(S // 7 + 1)[:S]    # p8
    return tuple(args)


@pytest.mark.parametrize("sides", [2, 8, 9, 30])
@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n", [64, 1000, 1008, 33])
def test_floodmin_kernel_sides_and_widths(dev, n, mode, sides):
    """K1's FloodMin instance: per-side minima for up to eight sides, the
    chunked walk with every link kept for more, payloads outside [0, V),
    widths of 1, 2 (n = 64), 8 warps a scenario, n % 16 != 0, S not a
    multiple of the scenarios a block."""
    algo = fused.FloodMinLoop(num_values=16, f=2)
    args = _many_sided_inputs(dev, n, 15, 16, n + sides, sides)
    got = fused._hist_loop_cuda(algo, *args, 5, mode)
    torch.cuda.synchronize()
    want = fused._hist_loop_plain(algo, *args, 5, mode)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1008, 33, 1024])
def test_lv_loop_kernel_widths_and_sides(dev, n):
    """K3 at widths with a partial last word, scenarios past a block's
    four, twelve sides healing mid-run, 40 rounds."""
    args = _many_sided_inputs(dev, n, 23, 40, n + 7, 12)
    got = fused._lv_loop_cuda(*args, 40)
    torch.cuda.synchronize()
    want = fused._lv_loop_plain(*args, 40)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_lean_route_on_a_side_stream(dev):
    """K1 and K3 launch on the caller's current stream of the tensor's
    device, through the lean route."""
    args = _loop_inputs(dev, 64, 7, 16, 3)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = [fused._hist_loop_cuda(fused.FloodMinLoop(num_values=16, f=2),
                                     *args, 4, "hw"),
               fused._lv_loop_cuda(*args, 8)]
    side.synchronize()
    want = [fused._hist_loop_plain(fused.FloodMinLoop(num_values=16, f=2),
                                   *args, 4, "hw"),
            fused._lv_loop_plain(*args, 8)]
    for g_, w_ in zip(got, want):
        for a, b in zip(g_, w_):
            assert torch.equal(a, b)
