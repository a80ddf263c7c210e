"""Fused round exchange: HO-mask generation + value histogram, the
whole-run histogram loop and the whole LastVoting run — the kernels of the
flagship path and the config ladder — and the two device probes of the
bisect tool.

Port of round_tpu/ops/fused.py.  For histogram rounds the whole round
exchange collapses to

    counts[s, v, j] = #{ i : deliver[s, j, i] and vals[s, i] == v }

and the [S, n, n] deliver mask never needs to exist in memory.  Mask
semantics:

    ho[j, i]      = (colmask[i] & (side[j] == side[i]) & keep(j, i)) | (i == j)
    deliver[j, i] = ho[j, i] & active[i] & rowmask[j]

with keep(j, i) drawn for link idx = j*n + i from one of two streams:

  * ``mode="hash"``, bit-exact with round_tpu:
        keep = fmix32(idx*GOLD + salt0 ^ salt1r) & 0xFF >= p8
  * ``mode="hw"`` (the default, as in round_tpu, whose hw mode draws from
    the TPU's hardware PRNG seeded with both salts): Philox4x32-10 keyed
    (salt0, salt1r).  Element e of the stream is word e & 3 of
    Philox(counter (e >> 2, 0, 0, 0)); link idx draws byte idx & 3 of
    element idx >> 2 (counter idx >> 4, word (idx >> 2) & 3), and
        keep = p8 <= 0 or draw >= min(p8, 255)
    so P(keep) = 1 - p8/256 exactly, as round_tpu's ``bits >= p8 << 24``.
    The TPU's bits cannot be reproduced: hw mode agrees with round_tpu in
    distribution, and within the port every hw kernel agrees bit for bit
    with its plain version (``philox4x32_10`` is the plain twin of
    csrc/hash.cuh::rt_philox4x32_10).

salt1r = r*RMIX + salt1 is premixed by the caller of K2 and derived per
round inside K1, so for one (scenario, round) both draw the same bits in
either mode: run_hist and the whole-run loops agree bit for bit.

Kernels, hand-written in CUDA C++ for Hopper (``csrc/``):

  * K2 ``hist_exchange`` (replaces round_tpu ``_kernel``): one round's counts.
  * K1 ``hist_loop`` (replaces round_tpu ``_loop_kernel``): the whole run,
    state on chip across rounds, one instance per LoopAlgo — ``otr_loop``,
    ``floodmin_loop`` and ``benor_loop`` (csrc/hist_loop.cu).
  * K3 ``lv_loop`` (replaces round_tpu ``_lv_kernel``): the whole
    LastVoting run, O(n) hashes per round (csrc/lv_loop.cu); hash mode
    only, as in round_tpu.
  * P1 ``probe_double`` and P2 ``philox_bits`` (replace
    tools/tpu_bisect.py's ``stage_pallas_min`` and ``stage_pallas_prng``;
    csrc/probe.cu).

Each wrapper takes the kernel for CUDA tensors and its plain PyTorch
version, in this module, for CPU tensors; there is no fallback from one to
the other.  Each kernel launch adds one to ``LAUNCHES[name]``; K1 and K2
count hw-mode launches under ``<name>_hw``.

Hashing runs in int64 holding uint32 values (``& 0xFFFFFFFF`` after every
wrapping step): torch on the CPU has no ``>>`` or ``>=`` for uint32, and an
int64 product keeps its low 32 bits exact.  Salts arrive as int32 bit
patterns and are widened with ``_u32``.

Knobs that exist only for TPU lowering (``sb``, ``interpret``, ``variant``)
are not carried over.  ``dot`` stays in the signatures and is validated;
K2 and K1's OTR and Ben-Or instances count with int8 tensor-core products
(mma.sync m16n8k32, u8 x u8 -> s32, csrc/count_mma.cuh) whichever value is
passed: like both round_tpu dtypes, the product is exact and gives the
same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from round_tpu_torch.ops import _native
from round_tpu_torch.ops.mailbox import first_true

_GOLD = 0x9E3779B9
_RMIX = 0x7FEB352D
_COIN = 0x1B873593  # domain separator: lane-coin stream vs link stream
_M32 = 0xFFFFFFFF
# Philox4x32 multipliers and key increments (Random123)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# Shared memory one block may use on Hopper (H100: 227 KB).
_MAX_SMEM = 232_448
# Plain versions materialise [chunk, n, n] int64 hashes; keep one such
# tensor near 128 MB so the card (and the CPU) can run them at n=1024.
_PLAIN_ELEMS = 1 << 24

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES: Dict[str, int] = {
    "hist_exchange": 0, "hist_exchange_hw": 0,
    "otr_loop": 0, "otr_loop_hw": 0,
    "floodmin_loop": 0, "floodmin_loop_hw": 0,
    "benor_loop": 0, "benor_loop_hw": 0,
    "lv_loop": 0, "probe_double": 0, "philox_bits": 0,
    # K4 (parallel/ici.py::ring_exchange): int32 codes, int8 bit-planes;
    # and the same launches by path: one card, or distinct cards
    "ring_exchange": 0, "ring_exchange_i8": 0,
    "ring_exchange_local": 0, "ring_exchange_peers": 0,
}

# the kernels' entry points, bound once, by the name of the first one
# asked for (K1 by instance; P1 and P2 share theirs)
_ENTRIES: Dict[str, Tuple] = {}
_PROBE_ENTRIES = ("probe", "probe_double_launch", "philox_bits_launch")
# a kernel's shared-memory bytes at a shape, asked of its library once
_SMEM: Dict[Tuple, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entries(library: str, *functions: str) -> Tuple:
    """The entry points `functions` of kernel `library`, bound once (the
    lean route: ``_native.bind``), kept under the first one's name."""
    fns = _ENTRIES.get(functions[0])
    if fns is None:
        fns = _ENTRIES[functions[0]] = _native.bind(library, *functions)
    return fns


def _smem(fn, *shape) -> int:
    """fn(*shape): a kernel's shared-memory bytes at a shape, asked of the
    library once per shape."""
    key = (fn.__name__, shape)
    got = _SMEM.get(key)
    if got is None:
        got = _SMEM[key] = fn(*shape)
    return got


def _u32(x) -> torch.Tensor:
    """uint32 value of an integer tensor (int32 bit pattern or any int64),
    as int64."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _i32(x) -> torch.Tensor:
    """int32 tensor with the low 32 bits of an integer tensor."""
    x = _u32(x)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _fmix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 — bit-exact with
    round_tpu/ops/fused.py::_fmix32 and engine/scenarios.py::_mix32."""
    z = _u32(z)
    z = z ^ (z >> 16)
    z = (z * 0x85EBCA6B) & _M32
    z = z ^ (z >> 13)
    z = (z * 0xC2B2AE35) & _M32
    z = z ^ (z >> 16)
    return z


def hash_coin(salt0, salt1, r, lane) -> torch.Tensor:
    """Deterministic fair coin per (scenario, lane, round): murmur3 over
    (lane, round, scenario salts) with its own stream constant, so coins
    never correlate with link drops (round_tpu/ops/fused.py::hash_coin).
    Accepts ints or tensors (broadcasts)."""
    z = _u32(_u32(lane) * _GOLD + _u32(salt0))
    z = z ^ _u32(_u32(r) * _RMIX + _u32(salt1) + _COIN)
    return (_fmix32(z) & 1) == 1


def _check_mode(mode: str) -> None:
    if mode not in ("hash", "hw"):
        raise ValueError(f"unknown mode {mode!r} (expected 'hash' or 'hw')")


def _launch_name(kernel: str, mode: str) -> str:
    """The LAUNCHES entry of a K1/K2 launch in `mode`."""
    return kernel + "_hw" if mode == "hw" else kernel


# ---------------------------------------------------------------------------
# The hw-mode stream: Philox4x32-10, and the probes P1 and P2
# ---------------------------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m, for uint32 values a held in int64
    and a uint32 constant m.  The 64-bit product overflows int64, so m is
    split into 16-bit halves: each partial product stays below 2^48."""
    ph = a * (m >> 16)
    t = a * (m & 0xFFFF) + ((ph & 0xFFFF) << 16)
    return (ph >> 16) + (t >> 32), t & _M32


def philox4x32_10(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11, "Random123"): the four output
    words for counter (c0, c1, c2, c3) under key (k0, k1), each word a
    uint32 value held in int64.  Counter and key words are ints or integer
    tensors (int32 bit patterns or uint32 values) and broadcast.  The plain
    twin of csrc/hash.cuh::rt_philox4x32_10; the generator that takes the
    place of the TPU's hardware PRNG (round_tpu/ops/fused.py::_keep_mask,
    hw branch)."""
    c = [_u32(w) for w in counter]
    k0, k1 = (_u32(w) for w in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return tuple(c)


def _philox_words(key0, key1, m: int, device, counter=(0, 0, 0, 0)):
    """[..., m] uint32 words (int64) of the stream keyed (key0, key1) (each
    [...] or a scalar): element e is word e & 3 of counter
    (c0 + (e >> 2), c1, c2, c3)."""
    t = torch.arange((m + 3) // 4, dtype=torch.int64, device=device)
    k0, k1 = _u32(key0)[..., None], _u32(key1)[..., None]
    c1, c2, c3 = counter[1:]
    w = philox4x32_10((t + counter[0], c1, c2, c3), (k0, k1))
    words = torch.stack(torch.broadcast_tensors(*w), dim=-1)
    return words.reshape(*words.shape[:-2], -1)[..., :m]


def _philox_bits_plain(seed: torch.Tensor, m: int, counter) -> torch.Tensor:
    """Plain version of the P2 kernel: m words as int32."""
    return _i32(_philox_words(seed[0], seed[1], m, seed.device, counter))


def _philox_bits_cuda(seed: torch.Tensor, shape, counter) -> torch.Tensor:
    launch = _entries(*_PROBE_ENTRIES)[1]
    key = (seed if seed.dtype == torch.int32 and seed.is_contiguous()
           else seed.to(torch.int32).contiguous())
    out = key.new_empty(shape)
    index = key.get_device()
    err = launch(key.data_ptr(), out.data_ptr(), out.numel(),
                 *[c & _M32 for c in counter], index,
                 _native.raw_stream(index))
    LAUNCHES["philox_bits"] += 1
    if err:
        _native.check(err, "philox_bits launch")
    return out


def philox_bits(seed: torch.Tensor, shape, counter=(0, 0, 0, 0)):
    """P2: random bits from a two-word seed, the port of
    tools/tpu_bisect.py::stage_pallas_prng (``prng_seed(s0, s1)`` then
    ``prng_random_bits(shape)``) on the hw-mode stream.

    ``seed`` is an int32 tensor [2]; returns int32 ``shape`` whose element
    e (row-major) is word e & 3 of Philox4x32-10(counter (c0 + (e >> 2),
    c1, c2, c3), key (seed[0], seed[1])).  The default counter base 0 is
    the stream the hw link draws read; another base serves the
    known-answer vectors.  A CUDA seed launches csrc/probe.cu through the
    lean route (``_native``), a CPU seed runs the plain version."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.as_tensor(seed)
    if seed.shape != (2,):
        raise ValueError(f"philox_bits: seed of shape {tuple(seed.shape)}; "
                         "expected (2,)")
    shape = tuple(shape)
    counter = tuple(map(int, counter))
    if seed.is_cuda:
        return _philox_bits_cuda(seed, shape, counter)
    if seed.device.type == "cpu":
        return _philox_bits_plain(seed, math.prod(shape),
                                  counter).reshape(shape)
    raise ValueError(f"philox_bits: unsupported device {seed.device}")


def probe_double(x: torch.Tensor) -> torch.Tensor:
    """P1: ``2 * x`` for a float32 tensor, the port of
    tools/tpu_bisect.py::stage_pallas_min (the smallest kernel that proves
    the toolchain builds and launches).  A CUDA tensor launches
    csrc/probe.cu through the lean route (``_native``): nothing but the
    checks, the output, the launch and its count happens per call.  A CPU
    tensor takes the plain version."""
    if x.dtype != torch.float32:
        raise ValueError(f"probe_double: dtype {x.dtype}; expected float32")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return x * 2.0
        raise ValueError(f"probe_double: unsupported device {x.device}")
    launch = _entries(*_PROBE_ENTRIES)[0]
    x = x.contiguous()
    out = torch.empty_like(x)
    index = x.get_device()
    err = launch(x.data_ptr(), out.data_ptr(), x.numel(), index,
                 _native.raw_stream(index))
    LAUNCHES["probe_double"] += 1
    if err:
        _native.check(err, "probe_double launch")
    return out


def _check_dot(dot: str) -> None:
    if dot not in ("i8", "bf16"):
        raise ValueError(f"unknown dot {dot!r} (expected 'i8' or 'bf16')")


def _hw_draws(n: int, salt0, salt1r) -> torch.Tensor:
    """[c, n(recv), n(send)] 8-bit hw-mode draws of one round: link
    idx = j*n + i takes byte idx & 3 of element idx >> 2 of the stream
    keyed (salt0, salt1r) ([c] each)."""
    salt0 = torch.as_tensor(salt0)
    c = salt0.shape[0]
    words = _philox_words(salt0, salt1r, (n * n + 3) // 4, salt0.device)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=salt0.device)
    draws = (words[..., None] >> shifts) & 0xFF  # [c, elements, 4 bytes]
    return draws.reshape(c, -1)[:, :n * n].reshape(c, n, n)


def _keep_mask(n: int, mode: str, salt0, salt1r, p8) -> torch.Tensor:
    """[c, n(recv), n(send)] per-link delivery mask for one round of c
    scenarios: the mode's keeps minus the diagonal (round_tpu/ops/fused.py::
    _keep_mask, in receiver-major layout).  salt0/salt1r/p8 are [c]."""
    _check_mode(mode)
    p8 = torch.as_tensor(p8).to(torch.int64)
    dev = p8.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    if mode == "hw":
        keep = ((_hw_draws(n, salt0, salt1r)
                 >= torch.clamp(p8, max=255)[:, None, None])
                | (p8 <= 0)[:, None, None])
    else:
        idx = ids[:, None] * n + ids[None, :]  # receiver j * n + sender i
        z = _u32(idx * _GOLD + _u32(salt0)[:, None, None])
        z = z ^ _u32(salt1r)[:, None, None]
        keep = (_fmix32(z) & 0xFF) >= p8[:, None, None]
    return keep & (ids[:, None] != ids[None, :])


def _chunks(S: int, n: int):
    step = max(1, _PLAIN_ELEMS // max(1, n * n))
    for a in range(0, S, step):
        yield slice(a, min(S, a + step))


def _count(onehot: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """counts[c, v, j] = Σ_i onehot[c, v, i] · keep[c, j, i], exact: 0/1
    operands and sums ≤ n < 2^24 in float32."""
    return torch.bmm(onehot.to(torch.float32),
                     keep.transpose(1, 2).to(torch.float32))


# ---------------------------------------------------------------------------
# K2: one round's fused exchange + histogram
# ---------------------------------------------------------------------------

def _hist_exchange_plain(vals, senders, rowmask, side, salt0, salt1r, p8,
                         num_values: int, mode: str) -> torch.Tensor:
    """Plain version of the K2 kernel: counts without the diagonal."""
    S, n = vals.shape
    rows = torch.arange(num_values, dtype=vals.dtype, device=vals.device)
    out = torch.empty((S, num_values, n), dtype=torch.float32,
                      device=vals.device)
    for sl in _chunks(S, n):
        keep = _keep_mask(n, mode, salt0[sl], salt1r[sl], p8[sl])
        if side is not None:
            sd = side[sl]
            keep = keep & (sd[:, :, None] == sd[:, None, :])
        onehot = (vals[sl][:, None, :] == rows[None, :, None]) \
            & senders[sl][:, None, :]
        counts = _count(onehot, keep)
        if rowmask is not None:
            counts = counts * (rowmask[sl] != 0)[:, None, :].to(torch.float32)
        out[sl] = counts
    return out


def _kernel_inputs(device, S: int, n: int, lanes, scalars):
    """A kernel's [S, n] (`lanes`, None passes through) and [S] (`scalars`)
    inputs as dense int32 rows, after checking device and shape: a tensor
    that already is one is passed as it is."""
    out = []
    for t, shape in [(t, (S, n)) for t in lanes] + [(t, (S,)) for t in scalars]:
        if t is None:
            out.append(None)
            continue
        if t.shape != shape or t.device != device:
            raise ValueError(
                f"kernel input of shape {tuple(t.shape)} on {t.device}; "
                f"expected {shape} on {device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            t = t.to(torch.int32).contiguous()
        out.append(t)
    return out


def _crash_bytes(crashed, device, S: int, n: int) -> torch.Tensor:
    """K1's and K3's crash set: a dense [S, n] bool tensor, whose bytes the
    kernels read (a bool tensor is passed as it is)."""
    if crashed.shape != (S, n) or crashed.device != device:
        raise ValueError(
            f"crashed of shape {tuple(crashed.shape)} on {crashed.device}; "
            f"expected {(S, n)} on {device}")
    if crashed.dtype != torch.bool:
        crashed = crashed != 0
    return crashed.contiguous()


def _hist_exchange_cuda(vals, senders, rowmask, side, salt0, salt1r, p8,
                        num_values: int, mode: str) -> torch.Tensor:
    """Launch K2 (csrc/hist_exchange.cu) in `mode`, on the lean route."""
    launch, smem_bytes = _entries("hist_exchange", "hist_exchange_launch",
                                  "hist_exchange_smem_bytes")
    S, n = vals.shape
    smem = _smem(smem_bytes, n, num_values)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"hist_exchange: num_values={num_values} at n={n} needs {smem} "
            f"bytes of shared memory per block (max {_MAX_SMEM})")
    args = _kernel_inputs(vals.device, S, n, (vals, senders, rowmask, side),
                          (salt0, salt1r, p8))
    out = vals.new_empty((S, num_values, n), dtype=torch.float32)
    index = vals.get_device()
    err = launch(*[None if a is None else a.data_ptr() for a in args],
                 out.data_ptr(), S, n, num_values, int(mode == "hw"), index,
                 _native.raw_stream(index))
    LAUNCHES[_launch_name("hist_exchange", mode)] += 1
    if err:
        _native.check(err, "hist_exchange launch")
    return out


def hist_exchange(
    vals: torch.Tensor,      # [S, n] int
    active: torch.Tensor,    # [S, n] bool/int
    colmask: torch.Tensor,   # [S, n] bool/int
    rowmask,                 # [S, n] bool/int, or None (= all on)
    side,                    # [S, n] int, or None (= no partition)
    salt0: torch.Tensor,     # [S] int32
    salt1r: torch.Tensor,    # [S] int32 (round premixed)
    p8: torch.Tensor,        # [S] int32
    num_values: int,
    mode: str = "hw",
    dot: str = "i8",
) -> torch.Tensor:
    """Fused masked exchange + per-value histogram (round_tpu/ops/fused.py::
    hist_exchange), its links drawn in `mode` ("hw" or "hash").  Returns
    counts [S, num_values, n] float32 (exact integers): counts[s, v, j] =
    number of senders i with deliver[s, j, i] and vals[s, i] == v.

    CUDA tensors launch the K2 kernel (csrc/hist_exchange.cu); CPU tensors
    take its plain version.  As in round_tpu, senders of scenarios with
    p8 >= 256 are silenced (a total blackout) and the self-delivery
    diagonal is added here, outside the kernel, from ``active`` (and
    ``rowmask``) alone.  ``dot`` is validated; the count is an exact int8
    tensor-core product either way."""
    _check_mode(mode)
    _check_dot(dot)
    vals = torch.as_tensor(vals).to(torch.int32)
    senders = (colmask != 0) & (active != 0) & (p8 < 256)[:, None]
    if vals.is_cuda:
        counts = _hist_exchange_cuda(vals, senders, rowmask, side, salt0,
                                     salt1r, p8, num_values, mode)
    elif vals.device.type == "cpu":
        counts = _hist_exchange_plain(vals, senders, rowmask, side, salt0,
                                      salt1r, p8, num_values, mode)
    else:
        raise ValueError(f"hist_exchange: unsupported device {vals.device}")
    # self-delivery (Round.scala:114-117): a process always hears itself
    # while it is active and selected by the dest mask
    self_on = active != 0
    if rowmask is not None:
        self_on = self_on & (rowmask != 0)
    onehot_self = vals[:, None, :] == torch.arange(
        num_values, dtype=torch.int32, device=vals.device)[None, :, None]
    return counts + (onehot_self & self_on[:, None, :]).to(torch.float32)


# ---------------------------------------------------------------------------
# K1: the whole run, state on chip across rounds
# ---------------------------------------------------------------------------

class LoopAlgo:
    """Algorithm plugin for the whole-run loop (`hist_loop`), as in
    round_tpu/ops/fused.py::LoopAlgo.  Per-lane state is a tuple of [..., n]
    tensors; each (sub)round's mailbox arrives as the [..., v_pad, n] int32
    counts (row `num_values` is the mailbox size).

      init(x0)          -> tuple of [..., n] state tensors (int32 or bool)
      payload(k, us)    -> [..., n] int32 in [0, num_values) for subround k
      update(r, k, us, counts, size, n, coin)
                        -> (new_us, exit_ [..., n] bool); the template
                           applies the active-lane freeze.
      decided_slot      -> index in the state tuple of the bool decided flag.

    On the card each instance has its own policy in csrc/hist_loop.cu,
    named by ``kernel`` (its C entry points are ``<kernel>_launch``,
    ``<kernel>_smem_bytes`` and ``<kernel>_onehot_bytes``;
    ``kernel_param`` is the policy's one integer parameter); ``n_state`` is
    the length of the state tuple.
    """

    num_values: int
    phase_len: int = 1
    needs_coin: bool = False
    decided_slot: int = 1
    kernel: str = ""
    n_state: int = 0

    @property
    def kernel_param(self) -> int:
        return 0

    def init(self, x0) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def payload(self, k: int, us) -> torch.Tensor:
        raise NotImplementedError

    def update(self, r, k: int, us, counts, size, n: int, coin):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class OtrLoop(LoopAlgo):
    """OTR's round as a LoopAlgo — same math as engine.fast.OtrHist
    (Otr.scala:44-49 mmor/quorum).  State: (x, decided, decision, after)."""

    num_values: int = 16
    after_decision: int = 2
    phase_len: int = 1
    needs_coin: bool = False
    decided_slot: int = 1
    kernel: str = "otr_loop"
    n_state: int = 4

    @property
    def kernel_param(self) -> int:
        return self.after_decision

    def init(self, x0):
        return (
            x0.to(torch.int32),
            torch.zeros(x0.shape, dtype=torch.bool, device=x0.device),
            torch.full(x0.shape, -1, dtype=torch.int32, device=x0.device),
            torch.full(x0.shape, self.after_decision, dtype=torch.int32,
                       device=x0.device),
        )

    def payload(self, k, us):
        return us[0]

    def update(self, r, k, us, counts, size, n, coin):
        x, decided, decision, after = us
        V = self.num_values
        quorum_thr = (2 * n) // 3
        cvals = counts[..., :V, :]
        bestc = cvals.max(dim=-2).values
        rows = torch.arange(V, dtype=torch.int32, device=counts.device)[:, None]
        # smallest value among the most-often-received, written out rather
        # than left to argmax's tie behaviour
        bestv = torch.where(cvals == bestc[..., None, :], rows, V).min(
            dim=-2).values.to(torch.int32)
        quorum = size > quorum_thr
        superq = quorum & (bestc > quorum_thr)

        newly = superq & ~decided
        decided2 = decided | superq
        decision2 = torch.where(newly, bestv, decision)
        after2 = torch.where(decided2, after - 1, after)
        exit_ = decided2 & (after2 <= 0)
        x2 = torch.where(quorum, bestv, x)
        return (x2, decided2, decision2, after2), exit_


@dataclasses.dataclass(frozen=True)
class FloodMinLoop(LoopAlgo):
    """FloodMin as a LoopAlgo (FloodMin.scala:22-33;
    round_tpu/ops/fused.py::FloodMinLoop): fold min over the mailbox each
    round, decide after round f.  The min over delivered values falls out
    of the histogram: min{v : counts[v] > 0}.  State: (x, decided,
    decision)."""

    num_values: int = 16
    f: int = 2
    phase_len: int = 1
    needs_coin: bool = False
    decided_slot: int = 1
    kernel: str = "floodmin_loop"
    n_state: int = 3

    @property
    def kernel_param(self) -> int:
        return self.f

    def init(self, x0):
        return (
            x0.to(torch.int32),
            torch.zeros(x0.shape, dtype=torch.bool, device=x0.device),
            torch.full(x0.shape, -1, dtype=torch.int32, device=x0.device),
        )

    def payload(self, k, us):
        return us[0]

    def update(self, r, k, us, counts, size, n, coin):
        x, decided, decision = us
        V = self.num_values
        rows = torch.arange(V, dtype=torch.int32, device=counts.device)[:, None]
        present = counts[..., :V, :] > 0
        xm = torch.where(present, rows, V).min(dim=-2).values.to(torch.int32)
        x2 = torch.minimum(x, xm)  # self-delivery already includes own x
        deciding = torch.full(decided.shape, r > self.f, dtype=torch.bool,
                              device=decided.device)
        newly = deciding & ~decided
        decided2 = decided | deciding
        decision2 = torch.where(newly, x2, decision)
        return (x2, decided2, decision2), deciding


@dataclasses.dataclass(frozen=True)
class BenOrLoop(LoopAlgo):
    """Ben-Or as a LoopAlgo (BenOr.scala:11-88;
    round_tpu/ops/fused.py::BenOrLoop): two subrounds per phase.  Subround
    0 broadcasts (x, canDecide) encoded as v = x + 2·can (domain 4);
    subround 1 broadcasts the vote encoded as v = vote + 1 (domain 3, in
    the same 4-value histogram).  The coin is the deterministic hash coin
    (`hash_coin`), replayable in the general engine via
    BenOr(coin_salt=...).  State: (x, can, vote, decided, decision); x,
    can and decision are 0/1 int32, vote is {-1, 0, 1}."""

    num_values: int = 4
    phase_len: int = 2
    needs_coin: bool = True
    decided_slot: int = 3
    kernel: str = "benor_loop"
    n_state: int = 5

    def init(self, x0):
        z = torch.zeros(x0.shape, dtype=torch.int32, device=x0.device)
        return (x0.to(torch.int32), z, z - 1, z != 0, z)

    def payload(self, k, us):
        if k == 0:
            return us[0] + 2 * us[1]
        return us[2] + 1

    def update(self, r, k, us, counts, size, n, coin):
        x, can, vote, decided, decision = us
        half = n // 2
        c = [counts[..., v, :] for v in range(4)]
        if k == 0:
            t_cnt = c[1] + c[3]
            f_cnt = c[0] + c[2]
            vote_new = torch.where(
                (t_cnt > half) | (c[3] > 0), 1,
                torch.where((f_cnt > half) | (c[2] > 0), 0, -1),
            ).to(torch.int32)
            can_any = ((c[2] + c[3]) > 0).to(torch.int32)
            deciding = can != 0
            newly = deciding & ~decided
            decided2 = decided | deciding
            decision2 = torch.where(newly, x, decision)
            vote2 = torch.where(deciding, vote, vote_new)
            can2 = torch.where(deciding, can, can_any)
            return (x, can2, vote2, decided2, decision2), deciding
        t, f = c[2], c[1]
        x2 = torch.where(
            t > half, 1,
            torch.where(f > half, 0,
                        torch.where(t > 1, 1,
                                    torch.where(f > 1, 0,
                                                coin.to(torch.int32)))),
        ).to(torch.int32)
        can2 = ((t > half) | (f > half) | (can != 0)).to(torch.int32)
        x3 = torch.where(decided, x, x2)
        can3 = torch.where(decided, can, can2)
        return (x3, can3, vote, decided, decision), torch.zeros_like(decided)


def _hist_loop_chunk(algo: LoopAlgo, x0, crashed, side, crash_round,
                     heal_round, rotate_down, p8, salt0, salt1, rounds: int,
                     mode: str):
    """The plain whole-run template over c scenarios ([c, n] inputs)."""
    c, n = x0.shape
    dev = x0.device
    V = algo.num_values
    rows = torch.arange(V + 1, dtype=torch.int32, device=dev)[:, None]
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    crashed = crashed != 0
    us = algo.init(x0)
    done = torch.zeros((c, n), dtype=torch.bool, device=dev)
    dround = torch.full((c, n), -1, dtype=torch.int32, device=dev)
    period = torch.clamp(rotate_down, min=1)
    side_eq = side[:, :, None] == side[:, None, :]
    for r in range(rounds):
        alive = ~(crashed & (r >= crash_round)[:, None])
        victim = (r // period) % n
        rotated = (lane[None, :] == victim[:, None]) & (rotate_down > 0)[:, None]
        colmask = alive & ~rotated
        active = ~done
        senders = colmask & active & (p8 < 256)[:, None]
        keep = _keep_mask(n, mode, salt0, _u32(r * _RMIX + _u32(salt1)), p8)
        keep = keep & (side_eq | (r >= heal_round)[:, None, None])
        coin = (hash_coin(salt0[:, None], salt1[:, None], r, lane[None, :])
                if algo.needs_coin else None)
        k = r % algo.phase_len
        vals = algo.payload(k, us)
        # value indicator with the ones-row at row V (the mailbox size)
        oh = (vals[:, None, :] == rows) | (rows == V)
        counts = _count(oh & senders[:, None, :], keep).to(torch.int32)
        # self-delivery: active lanes always hear themselves, independent
        # of colmask/p8
        counts = counts + (oh & active[:, None, :]).to(torch.int32)
        us2, exit_ = algo.update(r, k, us, counts, counts[:, V], n, coin)
        us = tuple(torch.where(active, a2, a) for a2, a in zip(us2, us))
        done = done | (active & exit_)
        decided = us[algo.decided_slot]
        dround = torch.where(decided & (dround < 0), r, dround)
    return tuple(u.to(torch.int32) for u in us) + (done.to(torch.int32),
                                                    dround)


def _hist_loop_plain(algo, x0, crashed, side, crash_round, heal_round,
                     rotate_down, p8, salt0, salt1, rounds, mode):
    """Plain version of the K1 kernel: the whole run, scenario chunk by
    chunk (a [chunk, n, n] mask per round, never [S, n, n])."""
    S, n = x0.shape
    parts = [
        _hist_loop_chunk(algo, x0[sl], crashed[sl], side[sl],
                         crash_round[sl], heal_round[sl], rotate_down[sl],
                         p8[sl], salt0[sl], salt1[sl], rounds, mode)
        for sl in _chunks(S, n)
    ]
    return tuple(torch.cat(col, dim=0) for col in zip(*parts))


def _hist_loop_cuda(algo: LoopAlgo, x0, crashed, side, crash_round,
                    heal_round, rotate_down, p8, salt0, salt1, rounds: int,
                    mode: str):
    """Launch the K1 instance of `algo` (csrc/hist_loop.cu) in `mode`, on
    the lean route."""
    if not algo.kernel:
        raise ValueError(f"no CUDA kernel for {type(algo).__name__}")
    kernel = algo.kernel
    launch, smem_bytes, onehot_bytes = _entries(
        "hist_loop", kernel + "_launch", kernel + "_smem_bytes",
        kernel + "_onehot_bytes")
    S, n = x0.shape
    V = algo.num_values
    # the tensor-core instances keep the round's sender one-hot in shared
    # memory where it fits, else in device memory beside the state
    in_smem = _smem(smem_bytes, n, V, 1) <= _MAX_SMEM
    smem = _smem(smem_bytes, n, V, int(in_smem))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{kernel}: num_values={V} at n={n} needs {smem} bytes of "
            f"shared memory per block (max {_MAX_SMEM})")
    onehot = None if in_smem else x0.new_empty(
        (S * _smem(onehot_bytes, n, V),), dtype=torch.uint8)
    x0, side, *scalars = _kernel_inputs(
        x0.device, S, n, (x0, side),
        (crash_round, heal_round, rotate_down, p8, salt0, salt1))
    crashed = _crash_bytes(crashed, x0.device, S, n)
    out = x0.new_empty((algo.n_state + 2, S, n), dtype=torch.int32)
    index = x0.get_device()
    err = launch(x0.data_ptr(), crashed.data_ptr(), side.data_ptr(),
                 *[a.data_ptr() for a in scalars], out.data_ptr(),
                 None if onehot is None else onehot.data_ptr(), S, n, V,
                 rounds, algo.kernel_param, int(mode == "hw"), index,
                 _native.raw_stream(index))
    LAUNCHES[_launch_name(kernel, mode)] += 1
    if err:
        _native.check(err, f"{kernel} launch")
    return out.unbind(0)


def hist_loop(
    algo: LoopAlgo,
    x0: torch.Tensor,           # [S, n] int32 initial per-lane input
    crashed: torch.Tensor,      # [S, n] bool
    side: torch.Tensor,         # [S, n] int32
    crash_round: torch.Tensor,  # [S] int32
    heal_round: torch.Tensor,   # [S] int32
    rotate_down: torch.Tensor,  # [S] int32
    p8: torch.Tensor,           # [S] int32
    salt0: torch.Tensor,        # [S] int32
    salt1: torch.Tensor,        # [S] int32 (UNmixed; rounds premix inside)
    rounds: int,
    mode: str = "hw",
    dot: str = "i8",
):
    """Run a whole LoopAlgo workload (round_tpu/ops/fused.py::hist_loop),
    its links drawn in `mode` ("hw" or "hash").

    Returns (state_arrays, done, decided_round): state_arrays is the algo's
    state tuple as [S, n] int32 (bool slots as 0/1), done [S, n] bool,
    decided_round [S, n] int32.  CUDA tensors launch the algo's K1
    instance (csrc/hist_loop.cu: OtrLoop, FloodMinLoop, BenOrLoop); CPU
    tensors take the plain template.  ``dot`` is validated; OTR and Ben-Or
    count with an exact int8 tensor-core product either way, FloodMin
    keeps a running minimum."""
    _check_mode(mode)
    _check_dot(dot)
    args = (x0, crashed, side, crash_round, heal_round, rotate_down, p8,
            salt0, salt1)
    if x0.is_cuda:
        outs = _hist_loop_cuda(algo, *args, rounds, mode)
    elif x0.device.type == "cpu":
        outs = _hist_loop_plain(algo, *args, rounds, mode)
    else:
        raise ValueError(f"hist_loop: unsupported device {x0.device}")
    n_state = len(outs) - 2
    return tuple(outs[:n_state]), outs[n_state] != 0, outs[n_state + 1]


def otr_loop(
    x0, crashed, side, crash_round, heal_round, rotate_down, p8, salt0,
    salt1, num_values: int, rounds: int, after_decision: int = 2,
    mode: str = "hw", dot: str = "i8",
):
    """The whole OTR flagship workload in one kernel launch (the OtrLoop
    instance of `hist_loop`; round_tpu/ops/fused.py::otr_loop).

    Returns (x, decided, decision, after, done, decided_round), each [S, n]
    (decided/done as bool)."""
    algo = OtrLoop(num_values=num_values, after_decision=after_decision)
    (x, dec, decision, after), done, dround = hist_loop(
        algo, x0, crashed, side, crash_round, heal_round, rotate_down, p8,
        salt0, salt1, rounds=rounds, mode=mode, dot=dot,
    )
    return (x, dec != 0, decision, after, done, dround)


# ---------------------------------------------------------------------------
# K3: the whole LastVoting run, O(n) hashes per round
# ---------------------------------------------------------------------------

def _lv_keep(idx, s0, salt1r, p8) -> torch.Tensor:
    """One hash-keep vector (a row or column of the link mask) — bit-exact
    with scenarios.link_bernoulli / from_fault_params at the same indices
    (round_tpu/ops/fused.py::_lv_keep).  LastVoting's rounds each touch one
    receiver row (collect/ack at the coordinator) or one sender column (the
    coordinator's broadcasts), so a round costs O(n) hashes."""
    p8 = torch.as_tensor(p8).to(torch.int64)
    z = _u32(_u32(idx) * _GOLD + _u32(s0))
    z = z ^ _u32(salt1r)
    return ((_fmix32(z) & 0xFF) >= p8) | (p8 <= 0)


def _lv_loop_plain(x0, crashed, side, crash_round, heal_round, rotate_down,
                   p8, salt0, salt1, rounds: int):
    """Plain version of the K3 kernel: round_tpu/ops/fused.py::_lv_kernel
    over all S scenarios at once ([S, n] tensors), one Python step per
    round.  Returns the nine [S, n] int32 outputs (x, ts, ready, commit,
    vote, decided, decision, done, decided_round)."""
    S, n = x0.shape
    dev = x0.device
    lane = torch.arange(n, device=dev)
    half = n // 2
    crashed = crashed != 0
    side = side.to(torch.int32)
    s0 = salt0[:, None]
    p8c = p8[:, None]
    period = torch.clamp(rotate_down, min=1)
    z = torch.zeros((S, n), dtype=torch.int32, device=dev)
    x, ts, vote, dec, dround = x0.to(torch.int32), z - 1, z, z - 1, z - 1
    ready = commit = decided = done = z != 0
    for r in range(rounds):
        phase, k = divmod(r, 4)
        coord = phase % n
        coh = (lane == coord)[None, :]
        alive = ~(crashed & (r >= crash_round)[:, None])
        victim = (r // period) % n
        rotated = (lane[None, :] == victim[:, None]) & (rotate_down > 0)[:, None]
        colmask = alive & ~rotated
        side_r = torch.where((r < heal_round)[:, None], side, 0)
        side_c = side_r[:, coord:coord + 1]
        salt1r = _u32(r * _RMIX + _u32(salt1))[:, None]
        active = ~done
        exit_ = torch.zeros_like(done)
        if k in (0, 2):
            # mailbox at receiver = coord: one receiver row of the mask
            keep = _lv_keep(coord * n + lane[None, :], s0, salt1r, p8c)
            mask = ((colmask & (side_r == side_c) & keep) | coh) & active
            if k == 2:
                mask = mask & (ts == phase)
            have = mask.sum(dim=1)
            if k == 0:
                ts_m = torch.where(mask, ts, -2)
                best = ts_m.max(dim=1, keepdim=True).values
                cand = mask & (ts_m == best)
                # first True = smallest sender id (Mailbox.arg_best)
                bi = first_true(cand)
                best_x = x.gather(1, bi[:, None])
                act = coh & ((have > half) | ((r == 0) & (have > 0)))[:, None]
                vote2 = torch.where(act, best_x, vote)
                commit2 = commit | act
                x2, ts2, ready2, dec2, decided2 = x, ts, ready, dec, decided
            else:
                ready2 = ready | (coh & (have > half)[:, None])
                x2, ts2, commit2, vote2 = x, ts, commit, vote
                dec2, decided2 = dec, decided
        else:
            # the coordinator's broadcast: one sender column of the mask
            keep = _lv_keep(lane[None, :] * n + coord, s0, salt1r, p8c)
            cm_c = colmask[:, coord:coord + 1]
            act_c = active[:, coord:coord + 1]
            guard_c = (commit if k == 1 else ready)[:, coord:coord + 1]
            got = ((cm_c & (side_r == side_c) & keep) | coh) & act_c & guard_c
            vote_c = vote[:, coord:coord + 1]
            if k == 1:
                x2 = torch.where(got, vote_c, x)
                ts2 = torch.where(got, phase, ts)
                ready2, commit2, vote2 = ready, commit, vote
                dec2, decided2 = dec, decided
            else:
                newly = got & ~decided
                decided2 = decided | got
                dec2 = torch.where(newly, vote_c, dec)
                ready2 = commit2 = torch.zeros_like(ready)
                x2, ts2, vote2 = x, ts, vote
                exit_ = got
        x = torch.where(active, x2, x)
        ts = torch.where(active, ts2, ts)
        ready = torch.where(active, ready2, ready)
        commit = torch.where(active, commit2, commit)
        vote = torch.where(active, vote2, vote)
        decided = torch.where(active, decided2, decided)
        dec = torch.where(active, dec2, dec)
        done = done | (active & exit_)
        dround = torch.where(decided & (dround < 0), r, dround)
    return tuple(t.to(torch.int32) for t in (
        x, ts, ready, commit, vote, decided, dec, done, dround))


def lv_key_fits(n: int, rounds: int) -> bool:
    """Whether K3's collect key (ts + 2) * n + (n - 1 - i), which picks the
    highest ts and then the smallest sender i with one 32-bit maximum, stays
    below 2^32 for every ts a run of `rounds` can reach (-1 up to
    ceil(rounds / 4) - 1)."""
    return ((rounds + 3) // 4 + 2) * n <= 1 << 32


def _lv_loop_cuda(x0, crashed, side, crash_round, heal_round, rotate_down,
                  p8, salt0, salt1, rounds: int):
    """Launch K3 (csrc/lv_loop.cu), on the lean route."""
    S, n = x0.shape
    if not lv_key_fits(n, rounds):
        raise ValueError(f"lv_loop: n={n} over {rounds} rounds overflows the "
                         "kernel's 32-bit collect key")
    launch, smem_bytes = _entries("lv_loop", "lv_loop_launch",
                                  "lv_loop_smem_bytes")
    smem = _smem(smem_bytes, n)
    if smem > _MAX_SMEM:
        raise ValueError(f"lv_loop: n={n} needs {smem} bytes of shared "
                         f"memory per scenario (max {_MAX_SMEM})")
    x0, side, *scalars = _kernel_inputs(
        x0.device, S, n, (x0, side),
        (crash_round, heal_round, rotate_down, p8, salt0, salt1))
    crashed = _crash_bytes(crashed, x0.device, S, n)
    out = x0.new_empty((9, S, n), dtype=torch.int32)
    index = x0.get_device()
    err = launch(x0.data_ptr(), crashed.data_ptr(), side.data_ptr(),
                 *[a.data_ptr() for a in scalars], out.data_ptr(), S, n,
                 rounds, index, _native.raw_stream(index))
    LAUNCHES["lv_loop"] += 1
    if err:
        _native.check(err, "lv_loop launch")
    return out.unbind(0)


def lv_loop(
    x0: torch.Tensor,           # [S, n] int32 initial estimates
    crashed: torch.Tensor,      # [S, n] bool
    side: torch.Tensor,         # [S, n] int32
    crash_round: torch.Tensor,  # [S] int32
    heal_round: torch.Tensor,   # [S] int32
    rotate_down: torch.Tensor,  # [S] int32
    p8: torch.Tensor,           # [S] int32
    salt0: torch.Tensor,        # [S] int32
    salt1: torch.Tensor,        # [S] int32 (UNmixed; rounds premix inside)
    rounds: int,
):
    """The whole LastVoting run in one kernel launch — O(n) hashes per
    round per scenario (round_tpu/ops/fused.py::lv_loop).  Hash-sampler
    masks only: they are bit-replayable in the general engine
    (scenarios.from_mix_row).

    Returns (x, ts, ready, commit, vote, decided, decision, done,
    decided_round), each [S, n] (ready/commit/decided/done as bool).  CUDA
    tensors launch K3 (csrc/lv_loop.cu); CPU tensors take the plain
    version."""
    args = (x0, crashed, side, crash_round, heal_round, rotate_down, p8,
            salt0, salt1)
    if x0.is_cuda:
        o = _lv_loop_cuda(*args, rounds)
    elif x0.device.type == "cpu":
        o = _lv_loop_plain(*args, rounds)
    else:
        raise ValueError(f"lv_loop: unsupported device {x0.device}")
    return (o[0], o[1], o[2] != 0, o[3] != 0, o[4], o[5] != 0, o[6],
            o[7] != 0, o[8])


# ---------------------------------------------------------------------------
# Dense oracles
# ---------------------------------------------------------------------------

def ho_link_mask(colmask, side, salt0, salt1r, p8) -> torch.Tensor:
    """[.., n(recv), n(send)] hash-mode HO matrix — the ``jg=None`` instance
    of ``ops.exchange.ho_block`` (round_tpu/ops/fused.py::ho_link_mask)."""
    from round_tpu_torch.ops.exchange import ho_block

    return ho_block(colmask, side, salt0, salt1r, p8)


def hist_exchange_reference(
    vals, active, colmask, rowmask, side, salt0, salt1r, p8, num_values
) -> torch.Tensor:
    """Dense oracle of hist_exchange in hash mode (same bits) —
    round_tpu/ops/fused.py::hist_exchange_reference."""
    S, n = vals.shape
    if rowmask is None:
        rowmask = torch.ones((S, n), dtype=torch.int32, device=vals.device)
    if side is None:
        side = torch.zeros((S, n), dtype=torch.int32, device=vals.device)
    ho = ho_link_mask(colmask, side, salt0, salt1r, p8)
    deliver = ho & (active != 0)[:, None, :] & (rowmask != 0)[:, :, None]
    onehot = vals[:, :, None] == torch.arange(
        num_values, dtype=vals.dtype, device=vals.device)[None, None, :]
    counts = torch.bmm(deliver.to(torch.float32), onehot.to(torch.float32))
    return counts.transpose(1, 2)
