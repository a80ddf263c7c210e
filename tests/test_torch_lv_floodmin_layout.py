"""Plain models of K3 (csrc/lv_loop.cu) and of K1's FloodMin instance
(csrc/hist_loop.cu, min_loop), held against their plain versions on the
CPU.

The index math the two kernels do in registers is written out here in
PyTorch:

  * K3 runs a scenario on one warp.  In the collect and ack rounds lane l
    takes the senders i = l (mod 32): `have` is the sum of the lanes'
    counts, and the pick of the highest ts, ties to the smallest sender,
    is one 32-bit maximum of the key (ts + 2) * n + (n - 1 - i), decoded
    as i = n - 1 - key % n.  done is a bitmask that is also the decided
    mask, and ready / commit are two flags of the current phase's
    coordinator, cleared at k = 3; the run ends once every lane is done
    or, at a phase's start, at most n / 2 lanes are left;
  * FloodMin's group of 1, 2, 4 or 8 warps walks a receiver's senders in
    aligned chunks of 16, G lanes a receiver (chunks c = cl (mod G)), one
    keep16 per chunk at link j * n + 16c (one Philox call, or the bytes
    idx0 & 15 .. +15 of two where n % 16 != 0; 16 folded finalizers in
    hash mode), the payloads read chunk-major (word q of chunk c at int4
    q * nc + c), then a shuffle minimum over the G lanes; a round that keeps
    every link (or has no sender) takes one minimum per side slot, the
    slots numbered in order of first appearance, up to eight.

The models equal _lv_loop_plain and _hist_loop_plain bit for bit, in both
link streams for FloodMin, over the p8 grid, with and without sides (and
with more sides than slots).  The models live here, not on the main path.
"""

import numpy as np
import pytest
import torch

from round_tpu_torch.ops import fused

P8_GRID = (0, 1, 13, 64, 128, 255, 256)
M32 = 0xFFFFFFFF
MAX_SIDES = 8  # count_mma.cuh::rt_kMaxSides


# -- K3 --------------------------------------------------------------------

def lv_key(ts, i, n):
    """lv_loop.cu's collect key of sender i with phase ts (int64)."""
    return (ts + 2) * n + (n - 1 - i)


@pytest.mark.parametrize("n", [4, 1000, 1024])
def test_lv_key_orders_as_the_reference(n):
    """Descending keys list the senders by highest ts, then smallest i, for
    every ts in [-1, phases) and i in [0, n); each key decodes to its i and
    stays below 2^32."""
    rounds = 40
    phases = (rounds + 3) // 4
    ts, i = torch.meshgrid(torch.arange(-1, phases, dtype=torch.int64),
                           torch.arange(n, dtype=torch.int64), indexing="ij")
    ts, i = ts.reshape(-1), i.reshape(-1)
    key = lv_key(ts, i, n)
    assert fused.lv_key_fits(n, rounds)
    assert int(key.min()) >= n and int(key.max()) < 2**32
    by_key = torch.argsort(key, descending=True)
    by_ref = torch.argsort(-ts * (n + 1) + i)   # ts down, then i up
    assert torch.equal(by_key, by_ref)
    assert torch.equal(n - 1 - key % n, i)
    assert torch.unique(key).numel() == key.numel()


def test_lv_key_fits_is_the_boundary():
    """The largest key of a run, (ceil(rounds / 4) + 1) * n + n - 1, fits
    exactly when lv_key_fits says so."""
    for n in (4, 1000, 1024, 4096):
        for rounds in (1, 4, 5, 40):
            top = lv_key(torch.tensor((rounds + 3) // 4 - 1), torch.tensor(0),
                         n)
            assert (int(top) < 2**32) == fused.lv_key_fits(n, rounds)
        # the last phase count whose key fits, and the first that does not
        phases = 2**32 // n - 2
        assert fused.lv_key_fits(n, 4 * phases)
        assert int(lv_key(torch.tensor(phases - 1), torch.tensor(0), n)) \
            < 2**32
        assert not fused.lv_key_fits(n, 4 * phases + 1)
        assert int(lv_key(torch.tensor(phases), torch.tensor(0), n)) \
            >= 2**32


def test_lv_wrapper_refuses_an_overflowing_key():
    n, rounds = 1024, 4 * (2**32 // 1024)
    assert not fused.lv_key_fits(n, rounds)
    z = torch.zeros((1, n), dtype=torch.int32)
    s = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit collect key"):
        fused._lv_loop_cuda(z, z, z, s, s, s, s, s, s, rounds)


def lv_model(x0, crashed, side, cr, hr, rot, p8, salt0, salt1, rounds):
    """One scenario of K3, as its warp runs it.  [n] int64 inputs, ints for
    the scalars; returns the nine outputs."""
    n = x0.shape[0]
    nw = (n + 31) // 32
    lane = torch.arange(n)
    x = x0.clone()
    ts = torch.full((n,), -1, dtype=torch.int64)
    vote = torch.zeros(n, dtype=torch.int64)
    dec = torch.full((n,), -1, dtype=torch.int64)
    drd = torch.full((n,), -1, dtype=torch.int64)
    done = torch.zeros(n, dtype=torch.bool)
    live, commit, ready, flagged = n, False, False, 0
    for r in range(rounds):
        phase, k = divmod(r, 4)
        # every lane done, or at a phase's start no majority is left: the
        # state is frozen for the rest of the run
        if live == 0 or (k == 0 and r > 0 and live <= n // 2):
            break
        coord = phase % n
        victim = (r // max(rot, 1)) % n
        sided = r < hr
        s1r = int(fused._u32(r * fused._RMIX + fused._u32(salt1)))
        act_c = not bool(done[coord])
        side_c = int(side[coord]) if sided else 0
        cm = ~(crashed & (r >= cr)) & ~((rot > 0) & (lane == victim))
        same = side == side_c if sided else torch.ones(n, dtype=torch.bool)
        if k in (0, 2):
            keep = fused._lv_keep(coord * n + lane, salt0, s1r, p8)
            inn = ~done & ((ts == phase) if k == 2 else True) \
                & ((lane == coord) | (cm & same & keep))
            # lane l's senders are i = l (mod 32): a word of 32 per ballot
            words = torch.zeros(nw * 32, dtype=torch.bool)
            words[:n] = inn
            have = int(words.reshape(nw, 32).sum())
            key = torch.zeros(nw * 32, dtype=torch.int64)
            key[:n] = torch.where(inn, lv_key(ts, lane, n), 0)
            best = int(key.reshape(nw, 32).max(dim=0).values.max())
            if act_c and k == 0 and (have > n // 2 or (r == 0 and have > 0)):
                vote[coord] = x[n - 1 - best % n]
                commit, flagged = True, coord
            elif act_c and k == 2 and have > n // 2:
                ready, flagged = True, coord
        elif act_c and (commit if k == 1 else ready):
            keep = fused._lv_keep(lane * n + coord, salt0, s1r, p8)
            got = ~done & ((lane == coord) | (cm[coord] & same & keep))
            if k == 1:
                x = torch.where(got, vote[coord], x)
                ts = torch.where(got, phase, ts)
            else:
                dec = torch.where(got, vote[coord], dec)
                drd = torch.where(got, r, drd)
                done = done | got
                live -= int(got.sum())
        if k == 3:
            commit = ready = False
    flag = lane == flagged
    return (x, ts, flag & ready, flag & commit, vote, done, dec, done, drd)


def _scenarios(n, S, seed, sides=2):
    """Numpy-made scenario rows: the p8 grid, crashes, partitions healing
    at various rounds, rotating suppression, random salts."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    crashed = t(rng.random((S, n)) < 0.2)
    side = t(rng.integers(0, sides, (S, n), dtype=np.int32))
    crash_round = t(rng.integers(0, 4, S, dtype=np.int32))
    heal_round = t(rng.integers(0, 10, S, dtype=np.int32))
    rotate_down = t(rng.choice(np.array([0, 1, 3], dtype=np.int32), S))
    p8 = t(np.resize(np.array(P8_GRID, dtype=np.int32), S))
    salt0 = t(rng.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32))
    salt1 = t(rng.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32))
    return crashed, side, crash_round, heal_round, rotate_down, p8, salt0, \
        salt1


@pytest.mark.parametrize("n", [4, 64, 1000])
def test_lv_model_equals_lv_loop_plain(n):
    S, rounds = len(P8_GRID) * 2, 20
    mix = _scenarios(n, S, 3 * n)
    rng = np.random.default_rng(n)
    x0 = torch.as_tensor(rng.integers(0, 40, (S, n), dtype=np.int32))
    want = fused._lv_loop_plain(x0, *mix, rounds)
    for s in range(S):
        crashed, side, cr, hr, rot, p8, s0, s1 = (a[s] for a in mix)
        got = lv_model(x0[s].to(torch.int64), crashed, side.to(torch.int64),
                       int(cr), int(hr), int(rot), int(p8), int(s0), int(s1),
                       rounds)
        for q, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g.to(torch.int32), w[s]), (s, q)


# -- K1's FloodMin instance --------------------------------------------------

def fm_group_warps(n):
    """hist_loop.cu::fm_group_warps: the fewest of 1, 2, 4, 8 warps that
    hold n lanes."""
    w = (n + 31) // 32
    return 1 if w <= 1 else 2 if w <= 2 else 4 if w <= 4 else 8


def fm_lanes(n):
    """(G, per): lanes of a receiver's chunks, receivers a warp takes at
    once."""
    nc = (n + 15) // 16
    G = 1
    while G < nc and G < 32:
        G *= 2
    return G, 32 // G


def fm_walk(n):
    """The chunked path's walk, as min_loop's loops run it: yields (warp,
    lane, receiver j, chunks of j this lane takes) for every j < n."""
    gw = fm_group_warps(n)
    G, per = fm_lanes(n)
    nc = (n + 15) // 16
    for warp in range(gw):
        for j0 in range(warp * per, n, gw * per):
            for lane in range(32):
                j = j0 + lane // G
                if j < n:
                    yield warp, lane, j, list(range(lane % G, nc, G))


@pytest.mark.parametrize("n", [64, 1000, 1008, 33])
def test_fm_chunk_partition_covers_every_link_once(n):
    nc = (n + 15) // 16
    G, _ = fm_lanes(n)
    cover = np.zeros((n, 16 * nc), dtype=np.int64)
    updaters = np.zeros(n, dtype=np.int64)
    for _warp, lane, j, chunks in fm_walk(n):
        for c in chunks:
            cover[j, 16 * c:16 * c + 16] += 1
        updaters[j] += lane % G == 0
    assert (cover[:, :n] == 1).all()
    assert (cover[:, n:] == 1).all()  # padded senders, payload V
    assert (updaters == 1).all()
    # the group and the block: 256 threads, a whole number of scenarios
    gw = fm_group_warps(n)
    assert 32 * gw >= min(n, 256) and 256 % (32 * gw) == 0


def fm_swz(i, nc):
    """hist_loop.cu::fm_swz: where sender i sits in a chunk-major array."""
    return ((((i >> 2) & 3) * nc + (i >> 4)) << 2) | (i & 3)


@pytest.mark.parametrize("n", [64, 1000, 1008, 33])
def test_fm_chunk_major_layout(n):
    """fm_swz permutes the 16 * nc lanes, keeps each word of four senders
    whole, and puts word q of consecutive chunks in consecutive 16 bytes:
    the G lanes of a receiver read distinct banks."""
    nc = (n + 15) // 16
    i = torch.arange(16 * nc)
    at = fm_swz(i, nc)
    assert torch.equal(torch.sort(at).values, i)
    word = at.reshape(nc, 4, 4) // 4                    # [c, q, b] -> int4
    assert bool((word == word[..., :1]).all())
    G, _ = fm_lanes(n)
    for q in range(4):
        banks = (word[:, q, 0] * 4) % 32                # the int4's first bank
        for c0 in range(0, nc, G):
            # a quarter warp (8 lanes, 16 bytes each) covers 32 banks once
            for g0 in range(0, G, 8):
                got = banks[c0 + g0:c0 + g0 + 8]
                assert torch.unique(got).numel() == got.numel()


def chunk_keep(n, mode, salt0, salt1r, p8):
    """[n, 16 * nc] keep bits, a chunk at a time as RtKeepStream::keep16
    draws them: chunk c of receiver j is links idx0 = j * n + 16c .. + 15."""
    nc = (n + 15) // 16
    draw = p8 > 0 and (mode == "hw" or p8 < 256)
    if not draw:
        return torch.full((n, 16 * nc), p8 <= 0, dtype=torch.bool)
    j = torch.arange(n, dtype=torch.int64)[:, None]
    idx0 = (j * n + 16 * torch.arange(nc, dtype=torch.int64)[None, :]) & M32
    sh = torch.arange(0, 32, 8, dtype=torch.int64)
    if mode == "hw":
        # one call at counter idx0 >> 4, and the next where idx0 & 15 != 0:
        # bytes idx0 & 15 .. +15 of the two (the funnel shift)
        c = idx0 >> 4
        words = []
        for ctr in (c, (c + 1) & M32):
            w = fused.philox4x32_10((ctr, 0, 0, 0), (salt0, salt1r))
            words += list(torch.broadcast_tensors(*w))
        b32 = ((torch.stack(words, -1)[..., None] >> sh) & 0xFF).reshape(
            n, nc, 32)
        off = (idx0 & 15)[..., None] + torch.arange(16)
        draws = torch.gather(b32, -1, off)
        y = min(p8, 255)
    else:
        # fmix32 with the round salt folded into its first xor
        link = (idx0[..., None] + torch.arange(16)) & M32
        k = (link * fused._GOLD + fused._u32(salt0)) & M32
        s1 = fused._u32(salt1r)
        z = k ^ (k >> 16) ^ (s1 ^ (s1 >> 16))
        z = (z * 0x85EBCA6B) & M32
        z = z ^ (z >> 13)
        z = (z * 0xC2B2AE35) & M32
        draws = (z ^ (z >> 16)) & 0xFF
        y = p8 & 0xFF
    return (draws >= y).reshape(n, 16 * nc)


@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n", [64, 1000, 1008])
def test_fm_keep16_index_is_the_link_index(mode, n):
    """Each chunk's keep bits are the stream's keep of links j * n + i for
    its senders i, as the plain version draws them (off the diagonal)."""
    _, _, _, _, _, p8, salt0, salt1 = _scenarios(n, len(P8_GRID), n)
    eye = torch.eye(n, dtype=torch.bool)
    for s in range(len(P8_GRID)):
        if int(p8[s]) >= 256:
            continue  # no sender: the group takes its minima, not chunks
        got = chunk_keep(n, mode, int(salt0[s]), int(salt1[s]),
                         int(p8[s]))[:, :n]
        want = fused._keep_mask(n, mode, salt0[s:s + 1], salt1[s:s + 1],
                                p8[s:s + 1])[0]
        assert torch.equal(got & ~eye, want), int(p8[s])


def side_slots(side):
    """min_loop's fm_side_slots: slots in order of first appearance; 0
    slots where there are more than MAX_SIDES sides."""
    seen = []
    for v in side.tolist():
        if v not in seen:
            seen.append(v)
    if len(seen) > MAX_SIDES:
        return 0, None
    return len(seen), torch.tensor([seen.index(v) for v in side.tolist()])


def floodmin_model(x0, crashed, side, cr, hr, rot, p8, salt0, salt1, rounds,
                   V, f, mode):
    """One scenario of K1's FloodMin instance, as its group runs it."""
    n = x0.shape[0]
    nc = (n + 15) // 16
    G, _ = fm_lanes(n)
    lane = torch.arange(n)
    x = x0.clone()
    decided = torch.zeros(n, dtype=torch.bool)
    decision = torch.full((n,), -1, dtype=torch.int64)
    done = torch.zeros(n, dtype=torch.bool)
    drd = torch.full((n,), -1, dtype=torch.int64)
    ns, slot = side_slots(side)
    split = ns != 1
    blackout = p8 >= 256
    for r in range(rounds):
        if bool(done.all()):
            break
        victim = (r // max(rot, 1)) % n
        sided = r < hr and split
        totals = blackout or (p8 <= 0 and (not sided or ns > 0))
        sender = ~done & ~(crashed & (r >= cr)) & ~((rot > 0) & (lane == victim))
        sender = sender & (not blackout)
        spay = torch.full((16 * nc,), V, dtype=torch.int64)
        spay[:n] = torch.where(sender & (x >= 0) & (x < V), x, V)
        if totals:
            # each warp's minimum per slot, then the slots' minima
            by_side = sided and ns > 0
            q = slot if by_side else torch.zeros(n, dtype=torch.int64)
            smin = torch.full((MAX_SIDES,), V, dtype=torch.int64)
            for w0 in range(0, n, 32):
                for z in range(ns if by_side else 1):
                    part = spay[w0:w0 + 32][:min(32, n - w0)]
                    part = torch.where(q[w0:w0 + 32] == z, part, V)
                    smin[z] = min(int(smin[z]), int(part.min()))
            m = smin[q]
        else:
            salt1r = int(fused._u32(r * fused._RMIX + fused._u32(salt1)))
            keep = chunk_keep(n, mode, salt0, salt1r, p8)
            if sided:
                sd = torch.zeros(16 * nc, dtype=torch.int64)
                sd[:n] = side
                keep = keep & (sd[None, :] == side[:, None])
            per_chunk = torch.where(keep, spay[None, :], V).reshape(
                n, nc, 16).min(-1).values                 # [n, nc]
            lanes = torch.full((n, G), V, dtype=torch.int64)
            for c in range(nc):
                lanes[:, c % G] = torch.minimum(lanes[:, c % G],
                                                per_chunk[:, c])
            m = lanes.min(-1).values                      # the shuffle
        m = torch.where((x >= 0) & (x < V), torch.minimum(m, x), m)
        x2 = torch.minimum(x, m)
        active = ~done
        deciding = r > f
        decision = torch.where(active & deciding & ~decided, x2, decision)
        decided = decided | (active & deciding)
        x = torch.where(active, x2, x)
        done = done | (active & deciding)
        drd = torch.where(decided & (drd < 0), r, drd)
    return x, decided, decision, done, drd


@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n,sides", [(64, 2), (1000, 2), (1008, 2), (64, 12)])
def test_floodmin_model_equals_hist_loop_plain(n, sides, mode):
    S, V, f, rounds = len(P8_GRID) * 2, 16, 2, 5
    mix = _scenarios(n, S, 5 * n + sides, sides)
    rng = np.random.default_rng(n + sides)
    # a few payloads outside [0, V): ignored as senders, kept as x
    x0 = torch.as_tensor(rng.integers(-2, V + 3, (S, n), dtype=np.int32))
    algo = fused.FloodMinLoop(num_values=V, f=f)
    want = fused._hist_loop_plain(algo, x0, *mix, rounds, mode)
    for s in range(S):
        crashed, side, cr, hr, rot, p8, s0, s1 = (a[s] for a in mix)
        got = floodmin_model(x0[s].to(torch.int64), crashed,
                             side.to(torch.int64), int(cr), int(hr), int(rot),
                             int(p8), int(s0), int(s1), rounds, V, f, mode)
        for q, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g.to(torch.int32), w[s]), (s, q)
