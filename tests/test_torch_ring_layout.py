"""A plain model of K4's walk, held against the all-gather on the CPU.

csrc/ring_exchange.cu copies every shard's [rows, row_bytes] chunk into
slot ``me`` of every shard's [rows, p * row_bytes] output, in bands of rows
that parallel/ici.py::_ring_plan cuts.  The kernel's index math is written
out here in numpy, as the kernel issues it:

  * ``ring_gather_local`` walks the bands of all shards with a grid
    stride.  On the bulk path one warp a block loads band k+1 into one of
    two shared buffers (one bulk copy) while band k is stored from the
    other, one bulk store a row and destination, lane i taking the stores
    i, i + 32, ... of the band in (destination, row) order.  On the
    register path 256 threads walk a band, ``lanes`` of them to a row, in
    units of 16, 4 or 1 bytes, each unit read once and written to every
    output.
  * ``ring_gather_peers`` takes the register walk over the bands of its
    own shard, blocks ``blockIdx.x, + nb, ...``.

The model must write every byte of every output exactly once, from the
right source byte, with every access aligned to its unit (bulk copies: 16
bytes, and sizes that are multiples of 16, within a band buffer).  The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from round_tpu_torch.parallel import ici

WARP = 32
MAX_BAND = 16384  # csrc/ring_exchange.cu kMaxBandBytes


def _band(plan, rows, g):
    """csrc/ring_exchange.cu::band_of: band g of all shards' bands."""
    me = g // plan.bands
    r0 = (g - me * plan.bands) * plan.band_rows
    return me, r0, min(plan.band_rows, rows - r0)


def _walk_band(plan, rows, row_bytes, p, me, r0, nr, write):
    """walk_band: the register walk of rows [r0, r0 + nr) of shard me."""
    shift = plan.lanes.bit_length() - 1
    per_row = row_bytes // plan.unit
    step = plan.threads >> shift
    for tid in range(plan.threads):
        lane = tid & (plan.lanes - 1)
        for r in range(tid >> shift, nr, step):
            src = (r0 + r) * row_bytes
            off = (r0 + r) * p * row_bytes + me * row_bytes
            for c in range(lane, per_row, plan.lanes):
                d = me
                for _ in range(p):  # every destination, from the own on
                    write(d, off + c * plan.unit, me, src + c * plan.unit,
                          plan.unit)
                    d = 0 if d + 1 == p else d + 1


def _gather_bulk(plan, rows, row_bytes, p, xs, outs, count):
    """gather_bulk: each block's bands through two shared buffers."""
    total = p * plan.bands
    band_bytes = plan.band_rows * row_bytes
    assert 2 * band_bytes <= 2 * MAX_BAND and band_bytes % 16 == 0
    for block in range(plan.blocks):
        bufs = [np.zeros(band_bytes, np.uint8), np.zeros(band_bytes, np.uint8)]

        def load(buf, g):
            me, r0, nr = _band(plan, rows, g)
            start, size = r0 * row_bytes, nr * row_bytes
            assert start % 16 == 0 and size % 16 == 0 and size <= band_bytes
            buf[:size] = xs[me][start:start + size]

        g, k = block, 0
        assert g < total
        load(bufs[0], g)
        while g < total:
            s = k & 1
            if g + plan.blocks < total:
                load(bufs[s ^ 1], g + plan.blocks)
            me, r0, nr = _band(plan, rows, g)
            for lane in range(WARP):
                for i in range(lane, nr * p, WARP):
                    d = i // nr
                    r = i - d * nr
                    dst = (r0 + r) * p * row_bytes + me * row_bytes
                    assert dst % 16 == 0 and (r * row_bytes) % 16 == 0
                    outs[d][dst:dst + row_bytes] = \
                        bufs[s][r * row_bytes:(r + 1) * row_bytes]
                    count[d][dst:dst + row_bytes] += 1
            g += plan.blocks
            k += 1


def _model(plan, rows, row_bytes, p, xs):
    """The outputs the kernel of `plan` writes, and how often it writes
    each of their bytes."""
    outs = [np.zeros(rows * p * row_bytes, np.uint8) for _ in range(p)]
    count = [np.zeros(rows * p * row_bytes, np.int32) for _ in range(p)]

    def write(d, dst, me, src, size):
        assert dst % size == 0 and src % size == 0  # the unit's alignment
        outs[d][dst:dst + size] = xs[me][src:src + size]
        count[d][dst:dst + size] += 1

    if plan.kernel == "local" and plan.path == "bulk":
        _gather_bulk(plan, rows, row_bytes, p, xs, outs, count)
    elif plan.kernel == "local":
        for block in range(plan.blocks):
            for g in range(block, p * plan.bands, plan.blocks):
                me, r0, nr = _band(plan, rows, g)
                _walk_band(plan, rows, row_bytes, p, me, r0, nr, write)
    else:
        for me in range(p):  # blockIdx.y: the shards of the launches
            for block in range(plan.blocks):
                for b in range(block, plan.bands, plan.blocks):
                    r0 = b * plan.band_rows
                    _walk_band(plan, rows, row_bytes, p, me, r0,
                               min(plan.band_rows, rows - r0), write)
    return outs, count


def _check(rows, row_bytes, p, sms=132, align=16, peer_blocks=None):
    plan = ici._ring_plan(rows, row_bytes, p, sms, align=align,
                          peer_blocks=peer_blocks)
    # every chunk and output starts on a multiple of `align`: a unit (a
    # bulk copy's 16 bytes) wider than that would be misaligned
    assert (16 if plan.path == "bulk" else plan.unit) <= align
    rng = np.random.default_rng(rows * 7919 + row_bytes * 31 + p)
    xs = [rng.integers(0, 256, rows * row_bytes, dtype=np.uint8)
          for _ in range(p)]
    outs, count = _model(plan, rows, row_bytes, p, xs)
    want = np.concatenate([x.reshape(rows, row_bytes) for x in xs],
                          axis=1).reshape(-1)
    for d in range(p):
        assert (count[d] == 1).all(), f"output {d}: a byte written " \
            f"{int(count[d].min())}..{int(count[d].max())} times"
        assert np.array_equal(outs[d], want)
    return plan


# (rows, row_bytes, p, align, path): the sharded flagship's int32 codes,
# the lattice family's int8 planes, 44-byte int8 rows ([5, 4, 11] through
# make_ring_gather), odd int32 widths, one-value rows, rows that fill a
# band buffer or pass it, pointers aligned to less than 16 bytes
CASES = [
    (2000, 1024, 4, 16, "bulk"),       # [2,000, 256] int32, p = 4
    (8, 352, 2, 16, "bulk"),           # [8, 352] int8, p = 2
    (5, 44, 2, 16, "register"),        # [5, 4, 11] int8
    (5, 44, 4, 16, "register"),
    (5, 44, 8, 16, "register"),
    (64, 2816, 2, 16, "bulk"),         # [64, 256 * 11] int8
    (64, 1024, 8, 16, "bulk"),         # [64, 256] int32
    (7, 1000, 4, 16, "register"),      # [7, 250] int32
    (1, 4, 8, 16, "register"),         # [1, 1] int32
    (3, 7, 2, 16, "register"),         # [3, 7] int8
    (4, 16384, 2, 16, "bulk"),         # a row fills a band buffer
    (3, 32768, 2, 16, "register"),     # a row passes it
    (64, 1024, 4, 4, "register"),      # a chunk 4-byte aligned
    (64, 1024, 2, 1, "register"),      # a chunk at an odd address
]


@pytest.mark.parametrize("rows,row_bytes,p,align,path", CASES)
def test_local_walk_writes_every_byte_once(rows, row_bytes, p, align, path):
    plan = _check(rows, row_bytes, p, align=align)
    assert (plan.kernel, plan.path) == ("local", path)
    assert plan.threads == (32 if path == "bulk" else 256)
    assert plan.blocks <= p * plan.bands


@pytest.mark.parametrize("rows,row_bytes,p,align,path", CASES)
def test_peers_walk_writes_every_byte_once(rows, row_bytes, p, align, path):
    if rows * row_bytes * p > 1 << 20:
        rows = 40  # the register walk of the model is slow in Python
    plan = _check(rows, row_bytes, p, align=align, peer_blocks=16)
    assert (plan.kernel, plan.path) == ("peers", "register")
    assert 1 <= plan.blocks <= 16


@pytest.mark.parametrize("rows,row_bytes,p,sms", [
    (37, 1024, 4, 2),     # 5 bands of 8 rows a shard, the last of 5
    (2001, 1024, 4, 132),  # the flagship's band of 8 rows, one row over
    (37, 44, 2, 1),       # register bands of 10 rows, the last of 7
    (100, 352, 8, 2),
])
def test_rows_not_divisible_by_the_band(rows, row_bytes, p, sms):
    plan = _check(rows, row_bytes, p, sms=sms)
    assert rows % plan.band_rows != 0
    assert plan.bands == -(-rows // plan.band_rows)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_the_flagship_plan_gives_every_sm_blocks(p):
    """[2,000, 1024 / p] int32 on 132 SMs: bulk bands of at most 8 KB, at
    least 132 blocks, a grid of at most four blocks an SM."""
    plan = ici._ring_plan(2000, 4096 // p, p, 132)
    assert plan.path == "bulk"
    assert plan.band_rows * 4096 // p <= 8192
    assert 132 <= plan.blocks <= 4 * 132


@settings(max_examples=40, deadline=None, derandomize=True)
@given(rows=st.integers(1, 40), cols=st.integers(1, 70),
       itemsize=st.sampled_from([1, 4]), p=st.sampled_from([2, 4, 8]),
       sms=st.sampled_from([1, 3, 132]), align=st.sampled_from([1, 4, 16]),
       peers=st.booleans())
def test_walk_sweep(rows, cols, itemsize, p, sms, align, peers):
    _check(rows, cols * itemsize, p, sms=sms, align=align,
           peer_blocks=3 if peers else None)


def test_plan_refuses_offsets_past_32_bits():
    with pytest.raises(ValueError, match="32-bit"):
        ici._ring_plan(1 << 16, 1 << 13, 4, 132)


def test_alignment_of_pointers():
    assert ici._alignment([0x7F0000000000, 0x7F0000000400]) == 16
    assert ici._alignment([0x7F0000000000, 0x7F0000000404]) == 4
    assert ici._alignment([0x7F0000000001]) == 1
