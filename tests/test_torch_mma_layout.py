"""A plain model of the tensor-core count of K1 and K2, held against their
plain versions on the CPU.

csrc/count_mma.cuh, csrc/hist_exchange.cu and csrc/hist_loop.cu count a
round as int8 matrix products (mma.sync m16n8k32, u8 x u8 -> s32): the keep
bytes of a receiver's links, drawn straight from the link stream as 32-bit
words of four links each, times the sender one-hot.  The index math that
the kernels do in registers is written out here in PyTorch:

  * the keep words: for receiver j and the 16 senders i0 .. i0+15, one hw
    Philox call (counter (j*n + i0) >> 4) or, where n % 16 != 0, the bytes
    (j*n + i0) & 15 .. +15 of two calls; in hash mode the 16 fmix32 draws
    packed byte by byte, the finalizer's last xor made on the packed
    bytes; then the SWAR compare, 0x80 where kept;
  * the sender placement on the K axis: in a 64-sender block, sender
    16t + 8s + 4h + b sits at k-step s, column 16h + 4t + b, in both the
    keep operand and the one-hot;
  * the one-hot rows, OTR's row V for payloads outside [0, V), the sided
    mask, the diagonal taken out after the product, the self-delivery,
    and the lane reduction of the accumulator fragments (lane 4g + t holds
    rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 tile);
  * the shortcut of rounds that keep every link: the senders' totals.

The model's counts equal _hist_exchange_plain, and one round of the model
equals one round of _hist_loop_plain, bit for bit, in both link streams,
at n = 64, 1000 and 1008, with and without sides, over the p8 grid.  The
model lives here, not on the main path.
"""

import numpy as np
import pytest
import torch

from round_tpu_torch.ops import fused

P8_GRID = (0, 1, 13, 64, 128, 255, 256)
M32 = 0xFFFFFFFF
H = 0x80808080


def _bytes_of(words):
    """[..., w] uint32 words (int64) -> [..., 4w] bytes, little end first."""
    sh = torch.arange(0, 32, 8, dtype=torch.int64)
    return ((words[..., None] >> sh) & 0xFF).reshape(*words.shape[:-1], -1)


def _words_of(b):
    """[..., 4w] bytes -> [..., w] words."""
    sh = torch.arange(0, 32, 8, dtype=torch.int64)
    return (b.reshape(*b.shape[:-1], -1, 4) << sh).sum(-1)


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode): byte i of the result is byte (sel >> 4i)
    & 7 of the eight bytes a.b0 .. a.b3, b.b0 .. b.b3."""
    by = torch.cat([_bytes_of(a[..., None]), _bytes_of(b[..., None])], -1)
    return sum(by[..., (sel >> 4 * i) & 7] << 8 * i for i in range(4))


def _funnel_r(a, b, sh):
    """__funnelshift_r: the low word of (b:a) >> sh."""
    return (((b << 32) | a) >> sh) & M32


def _swar_keep(x, y):
    """count_mma.cuh::rt_keep_bytes: 0x80 in each byte of x that is >= y
    (1 <= y <= 255), from the top bits of (x | H) - ylo."""
    ylo = (y & 0x7F) * 0x01010101
    ylt = M32 if y < 128 else 0
    t = ((x | H) - ylo) & M32
    return ((x & t) | ((x | t) & ylt)) & H


def _threshold(mode, p8):
    """(draw, fill, y) of RtKeepStream."""
    draw = p8 > 0 and (mode == "hw" or p8 < 256)
    y = min(p8, 255) if mode == "hw" else p8 & 0xFF
    return draw, p8 <= 0, y


def keep_bytes(n, mode, salt0, salt1r, p8):
    """[n, kpad] keep bytes (0x80 kept) of one scenario-round, made as the
    kernels make them: 16 links a receiver at a time, as four words."""
    kpad = (n + 63) // 64 * 64
    draw, fill, y = _threshold(mode, p8)
    if not draw:
        return torch.full((n, kpad), 0x80 if fill else 0, dtype=torch.int64)
    j = torch.arange(n, dtype=torch.int64)[:, None]
    i0 = torch.arange(0, kpad, 16, dtype=torch.int64)[None, :]
    idx0 = (j * n + i0) & M32                           # [n, kpad / 16]
    if mode == "hw":
        c = idx0 >> 4
        w = fused.philox4x32_10((c, 0, 0, 0), (salt0, salt1r))
        v = fused.philox4x32_10(((c + 1) & M32, 0, 0, 0), (salt0, salt1r))
        b32 = _bytes_of(torch.stack(
            [*torch.broadcast_tensors(*w), *torch.broadcast_tensors(*v)], -1))
        off = (idx0 & 15)[..., None] + torch.arange(16)  # the funnel shift
        words = _words_of(torch.gather(b32, -1, off))    # [n, g, 4]
    else:
        # fmix32 of link ^ salt1r with the salt folded into the first step
        # (s1f = salt1r ^ salt1r >> 16), up to its last step, z ^= z >> 16,
        # whose low bytes count_mma.cuh::rt_pack_last packs four at a time
        link = (idx0[..., None] + torch.arange(16)) & M32
        k = (link * fused._GOLD + fused._u32(salt0)) & M32
        s1 = fused._u32(salt1r)
        z = k ^ (k >> 16) ^ (s1 ^ (s1 >> 16))
        z = (z * 0x85EBCA6B) & M32
        z = z ^ (z >> 13)
        z = ((z * 0xC2B2AE35) & M32).reshape(*idx0.shape, 4, 4)
        a = _prmt(z[..., 0], z[..., 1], 0x6240)
        b = _prmt(z[..., 2], z[..., 3], 0x4062)
        words = _prmt(a, b, 0x7610) ^ _funnel_r(a, b, 16)
    words = _swar_keep(words, y)
    return _bytes_of(words).reshape(n, kpad)


def k_order(kpad):
    """Sender at each K position: in block kb, k-step s, column 16h + 4t + b
    holds sender 64kb + 16t + 8s + 4h + b."""
    kb, s, h, t, b = torch.meshgrid(
        *(torch.arange(m) for m in (kpad // 64, 2, 2, 4, 4)), indexing="ij")
    return (64 * kb + 16 * t + 8 * s + 4 * h + b).reshape(-1)


def product(keep, onehot):
    """The fragments' sum: [n, kpad] keep bytes times [rows, kpad] one-hot
    bytes over the senders in K order, as the s32 accumulators hold it
    (128 x the count), shifted back."""
    order = k_order(keep.shape[1])
    acc = keep[:, order] @ onehot[:, order].T           # [n, rows]
    assert bool((acc & 0x7F == 0).all())
    return acc >> 7


def lane_columns(counts):
    """[n, rows] -> per fragment lane: {(g, t): [(j, v, count)]} over the
    16-receiver tiles, the lane holding rows g, g + 8 and columns 2t, 2t+1
    of each 8-value tile."""
    n, rows = counts.shape
    lanes = {}
    for j0 in range(0, n, 16):
        for g in range(8):
            for t in range(4):
                for j in (j0 + g, j0 + g + 8):
                    if j >= n:
                        continue
                    for v0 in range(0, rows, 8):
                        for v in (v0 + 2 * t, v0 + 2 * t + 1):
                            lanes.setdefault((g, t), []).append(
                                (j, v, int(counts[j, v])))
    return lanes


def _mask_sides(keep, side):
    kpad = keep.shape[1]
    sd = torch.zeros(kpad, dtype=torch.int64)
    sd[:side.shape[0]] = side
    sd[side.shape[0]:] = side[0]
    return keep * (side[:, None] == sd[None, :])


def exchange_counts(vals, senders, side, salt0, salt1r, p8, V, mode):
    """K2's counts of one scenario (no diagonal, no rowmask): [V, n]."""
    n = vals.shape[0]
    kpad = (n + 63) // 64 * 64
    rows = (V + 7) // 8 * 8
    draw, fill, y = _threshold(mode, int(p8))
    split = side is not None and bool((side != side[0]).any())
    code = torch.where(senders & (vals >= 0) & (vals < V), vals, -1)
    oh = torch.zeros((rows, kpad), dtype=torch.int64)
    i = torch.nonzero(code >= 0)[:, 0]
    oh[code[i], i] = 1
    if not draw and not split:
        counts = oh.sum(1)[None, :].expand(n, rows).clone()   # the totals
    else:
        keep = keep_bytes(n, mode, salt0, salt1r, int(p8))
        if split:
            keep = _mask_sides(keep, side.to(torch.int64))
        counts = product(keep, oh)
    # the receiver's own link, counted by the product, taken out after it
    j = torch.arange(n)
    own = senders & _own_keep(n, mode, salt0, salt1r, int(p8))
    hit = own & (code >= 0)
    counts[j[hit], code[hit]] -= 1
    return counts[:, :V].T


def _own_keep(n, mode, salt0, salt1r, p8):
    """keep(j * n + j) for every j: RtKeepStream::keep1."""
    draw, fill, y = _threshold(mode, p8)
    if not draw:
        return torch.full((n,), fill, dtype=torch.bool)
    return torch.diagonal(keep_bytes(n, mode, salt0, salt1r, p8)) != 0


def _inputs(n, S, seed, with_side):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    vals = t(rng.integers(0, 8, (S, n), dtype=np.int32))
    active = t(rng.random((S, n)) < 0.9)
    colmask = t(rng.random((S, n)) < 0.8)
    side = t(rng.integers(0, 3, (S, n), dtype=np.int32)) if with_side else None
    salt0 = t(rng.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32))
    salt1r = t(rng.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32))
    p8 = t(np.resize(np.array(P8_GRID, dtype=np.int32), S))
    return vals, active, colmask, side, salt0, salt1r, p8


def test_swar_keep_is_the_bytewise_compare():
    x = torch.arange(256, dtype=torch.int64)
    for y in range(1, 256):
        words = x | (((x + 77) % 256) << 8) | (((x * 3) % 256) << 16) \
            | ((255 - x) << 24)
        got = _bytes_of(_swar_keep(words, y)[:, None])
        want = (_bytes_of(words[:, None]) >= y) * 0x80
        assert torch.equal(got, want), y


@pytest.mark.parametrize("n", [64, 1000, 1008])
def test_k_order_is_a_permutation_of_each_block(n):
    kpad = (n + 63) // 64 * 64
    order = k_order(kpad)
    assert torch.equal(torch.sort(order).values, torch.arange(kpad))
    # lane t's 16 senders are its own Philox call: 16 consecutive senders,
    # four words in the (a0, a2) registers of k-steps 0 and 1
    blk = order[:64].reshape(2, 2, 4, 4)   # [s, h, t, b]
    for t in range(4):
        assert sorted(blk[:, :, t, :].reshape(-1).tolist()) == list(
            range(16 * t, 16 * t + 16))


@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n", [64, 1000, 1008])
def test_keep_words_are_the_link_stream(mode, n):
    """The keep bytes, made 16 links at a time from the twins (funnel-
    shifted where a row starts inside a Philox call), are the plain
    versions' per-link keep mask plus the diagonal."""
    _, _, _, _, salt0, salt1r, p8 = _inputs(n, len(P8_GRID), n, False)
    for s in range(len(P8_GRID)):
        keep = keep_bytes(n, mode, int(salt0[s]), int(salt1r[s]),
                          int(p8[s]))[:, :n] != 0
        want = fused._keep_mask(n, mode, salt0[s:s + 1], salt1r[s:s + 1],
                                p8[s:s + 1])[0]
        eye = torch.eye(n, dtype=torch.bool)
        assert torch.equal(keep & ~eye, want), int(p8[s])


@pytest.mark.parametrize("with_side", [False, True])
@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n", [64, 1000, 1008])
def test_model_counts_equal_hist_exchange_plain(n, mode, with_side):
    vals, active, colmask, side, salt0, salt1r, p8 = _inputs(
        n, len(P8_GRID), 7 * n + with_side, with_side)
    senders = colmask & active & (p8 < 256)[:, None]
    V = 8
    want = fused._hist_exchange_plain(vals, senders, None, side, salt0,
                                      salt1r, p8, V, mode)
    for s in range(len(P8_GRID)):
        got = exchange_counts(vals[s].to(torch.int64), senders[s],
                              None if side is None else side[s],
                              int(salt0[s]), int(salt1r[s]), p8[s], V, mode)
        assert torch.equal(got.to(torch.float32), want[s]), int(p8[s])


def _round0_model(algo, x0, crashed, side, crash_round, heal_round,
                  rotate_down, p8, salt0, salt1, mode):
    """Round 0 of K1's tensor-core instances for one scenario, as the
    kernel runs it: the one-hot (OTR's row V only when a payload is outside
    [0, V)), the product or the totals, the diagonal and the self-delivery
    in the lanes' columns, the lane reduction, the policy's update."""
    n = x0.shape[0]
    V = algo.num_values
    kpad = (n + 63) // 64 * 64
    r = 0
    salt1r = int(fused._u32(r * fused._RMIX + fused._u32(salt1)))
    alive = ~(crashed & (r >= crash_round))
    rotated = (torch.arange(n) == (r // max(int(rotate_down), 1)) % n) \
        & (rotate_down > 0)
    senders = alive & ~rotated & (p8 < 256)
    pay = algo.payload(0, algo.init(x0)).to(torch.int64)
    ones = isinstance(algo, fused.OtrLoop)
    inr = (pay >= 0) & (pay < V)
    row = torch.where(inr, pay, V if ones else -1)
    other = bool((senders & ~inr).any()) and ones
    rows = (V + int(other) + 7) // 8 * 8
    sided = r < int(heal_round) and bool((side != side[0]).any())
    draw, fill, y = _threshold(mode, int(p8))
    oh = torch.zeros((rows, kpad), dtype=torch.int64)
    i = torch.nonzero(senders & (row >= 0))[:, 0]
    oh[row[i], i] = 1
    if not draw and not sided:
        counts = oh.sum(1)[None, :].expand(n, rows).clone()
    else:
        keep = keep_bytes(n, mode, int(salt0), salt1r, int(p8))
        if sided:
            keep = _mask_sides(keep, side.to(torch.int64))
        counts = product(keep, oh)
    own = senders & _own_keep(n, mode, int(salt0), salt1r, int(p8))
    # each lane's columns: + self at its payload, - its own link in its row
    best = {}
    for (g, t), cells in lane_columns(counts).items():
        for j, v, c in cells:
            c += int(inr[j] and v == pay[j]) - int(own[j] and v == row[j])
            b = best.setdefault(j, [-1, V, 0, [0] * 4])
            if v < V and (c > b[0] or (c == b[0] and v < b[1])):
                b[0], b[1] = c, v
            if v <= V:
                b[2] += c
            if v < 4:
                b[3][v] += c
    hist = torch.zeros((V + 1, n), dtype=torch.int32)
    for j, (c, v, size, c4) in best.items():
        # one most-often-received value with count c, then the size
        if ones:
            hist[v, j] = c
            hist[V, j] = size + int(not inr[j])
        else:
            hist[:4, j] = torch.tensor(c4, dtype=torch.int32)
    us = algo.init(x0[None])
    if ones:
        # OtrLoop.update reads max over values and the smallest argmax:
        # the one column in hist carries both
        us2, exit_ = algo.update(r, 0, us, hist[None], hist[None, V], n,
                                 None)
    else:
        us2, exit_ = algo.update(r, 0, us, hist[None], hist[None, 4], n,
                                 None)
    decided = us2[algo.decided_slot][0] != 0
    return tuple(u.to(torch.int32)[0] for u in us2) + (
        exit_.to(torch.int32)[0],
        torch.where(decided, 0, -1).to(torch.int32))


@pytest.mark.parametrize("algo", [fused.OtrLoop(num_values=8),
                                  fused.BenOrLoop()],
                         ids=["otr", "benor"])
@pytest.mark.parametrize("mode", ["hash", "hw"])
@pytest.mark.parametrize("n", [64, 1000, 1008])
def test_model_round_equals_hist_loop_plain(n, mode, algo):
    """One round of the model equals one round of _hist_loop_plain, for
    rows of every family (crashes, a partition with three sides healing
    later, a rotating victim) over the p8 grid; x0 reaches past [0, V)
    in one row, so OTR's row V is exercised."""
    S = len(P8_GRID) + 1
    rng = np.random.default_rng(n + len(mode))
    V = algo.num_values
    hi = V if isinstance(algo, fused.OtrLoop) else 2
    x0 = torch.as_tensor(rng.integers(0, hi, (S, n), dtype=np.int32))
    x0[-1, ::7] = V + 3
    crashed = torch.as_tensor(rng.random((S, n)) < 0.2)
    side = torch.as_tensor(rng.integers(0, 3, (S, n), dtype=np.int32))
    side[::2] = 0                                       # unsplit rows
    heal_round = torch.as_tensor(np.resize([0, 4], S).astype(np.int32))
    crash_round = torch.zeros(S, dtype=torch.int32)
    rotate_down = torch.as_tensor(np.resize([0, 0, 1], S).astype(np.int32))
    p8 = torch.as_tensor(np.resize(np.array(P8_GRID + (13,), np.int32), S))
    salt0 = torch.as_tensor(
        rng.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32))
    salt1 = torch.as_tensor(
        rng.integers(-2**31, 2**31, S, dtype=np.int64).astype(np.int32))
    args = (x0, crashed, side, crash_round, heal_round, rotate_down, p8,
            salt0, salt1)
    want = fused._hist_loop_plain(algo, *args, 1, mode)
    for s in range(S):
        got = _round0_model(algo, *(a[s] for a in args), mode)
        assert len(got) == len(want)  # the state, done, decided_round
        for q, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w[s]), (s, q)
