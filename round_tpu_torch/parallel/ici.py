"""The hand-written exchange of the sharded engines: one CUDA all-gather
in place of the library gathers.

Port of round_tpu/parallel/ici.py.  The proc-sharded runners
(parallel/mesh.py) distribute receivers over the ``proc`` mesh axis and,
per round, move each shard's O(n) sender vectors to every other shard.  The
"collective" control does that with two library gathers (payload +
sender-eligibility); ``exchange="ici"`` does it with ONE exchange of the
packed sender code (ops.exchange.hist_pack; for lattice agreement the int8
active mask and bit-planes) through the K4 kernel, ``ring_exchange``:

  * round_tpu's kernel forwards chunks around a torus ring in p−1 dependent
    steps, because a TPU has only neighbour links.  The cards of one host
    reach every peer in one hop, so here each shard's chunk goes straight
    into slot ``me`` of every shard's output (p−1 remote writes plus the
    local one): the same bytes as the ring (``ring_bytes_per_round``)
    without the chain.  The name stays so a reader finds the counterpart.
  * the kernel is picked by topology (``_launch_all``).  A ring whose
    shards all lie on one device takes ``ring_gather_local``, one launch
    for all shards, with no flags: each chunk is read once and written p
    times, through TMA bulk copies where rows and pointers are 16-byte
    aligned, else through registers (``_ring_plan`` says which, and cuts
    the chunks into bands).  Shards on distinct cards take
    ``ring_gather_peers``, one launch per card after peer access is
    enabled, and signal arrival inside the kernel, as the TPU kernel's
    semaphores do: flags written with release and polled with acquire at
    system scope, stamped with an epoch that only grows
    (csrc/ring_exchange.cu).  Launches count under the dtype's name and
    under ``ring_exchange_local`` or ``ring_exchange_peers``.

On CUDA shards ``exchange="ici"`` launches the kernel or raises; the plain
version (``_ring_exchange_plain``: ``torch.cat``) runs only where the
shards are CPU tensors.  What is not carried over from round_tpu:
``hlo_collective_bytes`` and ``tpu_lowering_flags`` (they read XLA HLO and
Mosaic output; the port's evidence that the ici path runs the kernel and no
library gather is ``LAUNCHES["ring_exchange"]`` and a zero count of
``all_gather`` calls) and ``roofline`` / ``ICI_GBPS_BAND`` (figures of the
TPU; the card's bound for K4 is computed by chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import functools
import json
import threading
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree

from round_tpu_torch.ops import _native
from round_tpu_torch.ops.fused import LAUNCHES
from round_tpu_torch.parallel import mesh as meshmod

#: blocks (gridDim.x) one shard may use on the peers path; bounds the flags
MAX_BLOCKS = 64
#: most shards one exchange takes (the launch passes pointers by value)
MAX_SHARDS = 64
#: a peers launch may take this share of the blocks a card keeps resident,
#: so that the rings of a (scenario × proc) mesh that share a card fit
#: beside each other while each spins on its peers' flags
_RESIDENT_SHARE = 4
#: nanoseconds a block waits for a peer's flag before it gives up
_TIMEOUT_NS = 20_000_000_000
#: bytes a band aims at, and the most one band buffer of the bulk path
#: holds (csrc/ring_exchange.cu kMaxBandBytes; two buffers a block)
_BAND_BYTES = 8192
_MAX_BAND_BYTES = 16384
#: blocks of a local launch for each SM of the card
_BLOCKS_PER_SM = 4
#: threads of a block: the register walk, and the bulk path's one warp
_THREADS, _BULK_THREADS = 256, 32
_LAUNCH_NAMES = {torch.int32: "ring_exchange", torch.int8: "ring_exchange_i8"}
_LOCK = threading.Lock()
_PEER_ENABLED = set()
_RESIDENT = {}  # device index -> blocks of the peers kernel kept resident
_SMS = {}  # device index -> streaming multiprocessors
# K4's bound entry points (local and peers launches, the residency query,
# peer access), once built
_RING = None


class _RingState:
    """What one ring keeps between calls: on the peers path, per rank the
    arrival flags ([p, MAX_BLOCKS] int32 on that rank's device, written by
    every peer) and a status word the kernel sets when it gave up, and the
    epoch (a ring on one device needs none of it); and the plan of its
    last exchange."""

    def __init__(self, p: int):
        self.flags: List = [None] * p
        self.status: List = [None] * p
        self.epoch = 0
        self.plan = None


class RingPlan(NamedTuple):
    """How K4 cuts one exchange (csrc/ring_exchange.cu)."""

    kernel: str     # "local" (every shard on one device) or "peers"
    path: str       # "bulk" (TMA bulk copies) or "register"
    unit: int       # bytes one access moves: 16, 4 or 1 (bulk: 16)
    lanes: int      # register path: lanes to a row, a power of two
    band_rows: int  # rows of a band
    bands: int      # bands of one shard's chunk
    blocks: int     # local: blocks of the launch; peers: blocks a shard
    threads: int    # threads of a block


@functools.lru_cache(maxsize=256)
def _ring_plan(rows: int, row_bytes: int, p: int, sms: int, *,
               align: int = 16, peer_blocks: Optional[int] = None
               ) -> RingPlan:
    """The plan of one exchange of p chunks of [rows, row_bytes] bytes on a
    card of `sms` SMs.  `align`: the largest power of two, up to 16, that
    divides the address of every chunk and output.  `peer_blocks`: None
    when every shard lies on one device (the local kernel), else the most
    blocks a shard may keep resident (the peers kernel).

    Units are the widest of 16, 4 and 1 bytes that divides the row and
    `align` (the slot offset me * row_bytes and the pitch p * row_bytes
    follow the row).  The local kernel takes the bulk path where that is
    16 and a row fits a band buffer.  A band holds about _BAND_BYTES, and
    fewer rows where that gives every SM _BLOCKS_PER_SM bands."""
    if rows < 1 or row_bytes < 1 or not 1 <= p <= MAX_SHARDS:
        raise ValueError(f"ring plan: rows={rows}, row_bytes={row_bytes}, "
                         f"p={p}")
    if rows * p * row_bytes >= 2**31:
        raise ValueError(f"ring_exchange: {p} outputs of {rows} x "
                         f"{p * row_bytes} bytes pass the kernel's 32-bit "
                         "offsets")
    unit = next(u for u in (16, 4, 1) if row_bytes % u == 0 and align >= u)
    local = peer_blocks is None
    bulk = local and unit == 16 and row_bytes <= _MAX_BAND_BYTES
    per_band = max(1, _BAND_BYTES // row_bytes)
    spread = (-(-rows * p // (sms * _BLOCKS_PER_SM)) if local
              else -(-rows // peer_blocks))
    band_rows = max(1, min(per_band, rows, spread))
    bands = -(-rows // band_rows)
    blocks = (min(p * bands, sms * _BLOCKS_PER_SM) if local
              else max(1, min(peer_blocks, bands)))
    per_row = row_bytes // unit
    lanes = 1 if bulk else min(_THREADS, 1 << (per_row - 1).bit_length())
    return RingPlan("local" if local else "peers",
                    "bulk" if bulk else "register", unit, lanes, band_rows,
                    bands, blocks, _BULK_THREADS if bulk else _THREADS)


def _ring_exchange_plain(chunks) -> List[torch.Tensor]:
    """Plain version of the K4 kernel: every shard's output is the chunks
    side by side, ``out[:, d*cols:(d+1)*cols] = shard d's x``, on that
    shard's device."""
    return [torch.cat([c.to(dst.device) for c in chunks], dim=1)
            for dst in chunks]


def _device_runs(items):
    """[(first rank, ranks...)] runs of consecutive ranks on one device.
    A device may hold one run: its shards share a launch."""
    runs = []
    for rank, item in enumerate(items):
        if runs and items[runs[-1][0]]["x"].device == item["x"].device:
            runs[-1].append(rank)
        else:
            runs.append([rank])
    seen = [items[run[0]]["x"].device for run in runs]
    if len(set(seen)) != len(seen):
        raise ValueError(
            "ring_exchange: the shards of one device must be neighbours on "
            f"the ring (devices in ring order: {[str(d) for d in seen]})")
    return runs


def _bind_ring():
    global _RING
    _RING = _native.bind("ring_exchange", "ring_gather_local_launch",
                         "ring_gather_peers_launch",
                         "ring_exchange_max_blocks", "ring_enable_peer")
    return _RING


def _sms(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def _alignment(pointers) -> int:
    """The largest power of two, up to 16, dividing every pointer."""
    bits = 16
    for ptr in pointers:
        bits |= ptr
    return bits & -bits


def _prepare_devices(state: _RingState, items, runs) -> int:
    """For the peers kernel: enable peer access among the ring's devices
    (once per pair), allocate each rank's flags and status word (once per
    ring) and return the fewest blocks of the kernel any of the devices
    keeps resident (queried once per card)."""
    _, _, max_blocks, enable_peer = _RING or _bind_ring()
    devices = [items[run[0]]["x"].device for run in runs]
    for d in devices:
        if d.index not in _RESIDENT:
            _RESIDENT[d.index] = max_blocks(d.index)
        if _RESIDENT[d.index] <= 0:
            raise RuntimeError(f"ring_exchange: the occupancy query failed "
                               f"on {d}")
    for a in devices:
        for b in devices:
            if a != b and (a.index, b.index) not in _PEER_ENABLED:
                _native.check(enable_peer(a.index, b.index),
                              f"peer access from {a} to {b}")
                _PEER_ENABLED.add((a.index, b.index))
    if state.flags[0] is None:
        p = len(items)
        for rank, it in enumerate(items):
            dev = it["x"].device
            state.flags[rank] = torch.zeros((p, MAX_BLOCKS),
                                            dtype=torch.int32, device=dev)
            state.status[rank] = torch.zeros((1,), dtype=torch.int32,
                                             device=dev)
        # the zeros are written on this thread's streams, the launches run
        # on the shards' streams: let the zeros land first, once
        for d in devices:
            torch.cuda.synchronize(d)
    return min(_RESIDENT[d.index] for d in devices)


def _launch_all(state: _RingState, items) -> List:
    """Launch K4 for every shard of one exchange, after the streams of ALL
    shards reached this call (their chunk is computed, their output is
    allocated): one local launch when every shard lies on one device, else
    one peers launch per device.  Each launch runs on the stream of its
    device's first shard.  Returns, per rank, the event that follows its
    device's launch, or None where the rank's stream is the launch's."""
    local_launch, peers_launch, _, _ = _RING or _bind_ring()
    p = len(items)
    x0 = items[0]["x"]
    rows, cols = x0.shape
    row_bytes = cols * x0.element_size()
    out_ptrs = [it["out"].data_ptr() for it in items]
    x_ptrs = [it["x"].data_ptr() for it in items]
    outs = (ctypes.c_void_p * p)(*out_ptrs)
    xs = (ctypes.c_void_p * p)(*x_ptrs)
    align = _alignment(out_ptrs + x_ptrs)
    events = [None] * p
    index = x0.get_device()
    if all(it["x"].get_device() == index for it in items):
        plan = state.plan = _ring_plan(rows, row_bytes, p, _sms(index),
                                       align=align)
        stream = items[0]["stream"]
        raw = items[0]["raw"]
        for it in items[1:]:
            if it["raw"] != raw:
                stream.wait_event(it["ready"])
        err = local_launch(outs, xs, p, rows, row_bytes,
                           int(plan.path == "bulk"), plan.unit, plan.lanes,
                           plan.band_rows, plan.blocks, index, raw)
        with _LOCK:
            LAUNCHES[_LAUNCH_NAMES[x0.dtype]] += 1
            LAUNCHES["ring_exchange_local"] += 1
        if err:
            _native.check(err, "ring_exchange launch")
        if any(it["raw"] != raw for it in items):
            done = torch.cuda.Event()
            done.record(stream)
            events = [None if it["raw"] == raw else done for it in items]
        return events
    runs = _device_runs(items)
    with _LOCK:
        resident = _prepare_devices(state, items, runs)
    most = max(len(run) for run in runs)
    plan = state.plan = _ring_plan(
        rows, row_bytes, p, _sms(index), align=align,
        peer_blocks=max(1, min(MAX_BLOCKS,
                               resident // (_RESIDENT_SHARE * most))))
    state.epoch += 1
    flags = _native.pointer_array(state.flags)
    for run in runs:
        first = items[run[0]]
        stream = first["stream"]
        for it in items:
            stream.wait_event(it["ready"])
        err = peers_launch(
            outs, xs, flags, state.status[run[0]].data_ptr(), p, rows,
            row_bytes, plan.unit, plan.lanes, plan.band_rows, plan.blocks,
            run[0], len(run), state.epoch, _TIMEOUT_NS,
            first["x"].get_device(), first["raw"])
        with _LOCK:
            LAUNCHES[_LAUNCH_NAMES[x0.dtype]] += 1
            LAUNCHES["ring_exchange_peers"] += 1
        _native.check(err, "ring_exchange launch")
        done = torch.cuda.Event()
        done.record(stream)
        for rank in run:
            events[rank] = done
    return events


def check_ring(group) -> None:
    """Raise if a K4 launch of this group gave up waiting for a peer.
    Called once the shards' streams are synchronised."""
    state = group.ring
    if state is None:
        return
    for rank, status in enumerate(state.status):
        if status is not None and int(status.item()) != 0:
            raise RuntimeError(
                f"ring_exchange: rank {rank} gave up waiting for a peer's "
                f"arrival flag (status {int(status.item())})")


def ring_exchange(x: torch.Tensor, *, axis: str, p: int) -> torch.Tensor:
    """``[S_l, cols]`` per-shard chunk -> ``[S_l, p * cols]`` full tensor,
    the shards' chunks in axis order (the column order of
    ``all_gather(x, axis, dim=1)``); int32 or int8.  Must run inside
    shard_map over `axis` with p shards; on a mesh with further axes the
    exchange stays among the shards that share this shard's other
    coordinates (round_tpu/parallel/ici.py::ring_exchange).

    CUDA shards launch K4 (csrc/ring_exchange.cu).  It is not round_tpu's
    ring: every chunk goes straight into its slot of every shard's output,
    since a card reaches each peer in one hop; on distinct cards the kernel
    waits until every peer's chunk has arrived.  The output is valid on the
    calling thread's current stream.  CPU shards take the plain version."""
    if x.dim() != 2 or x.numel() == 0 or x.dtype not in _LAUNCH_NAMES:
        raise ValueError(f"ring_exchange: x of shape {tuple(x.shape)} and "
                         f"dtype {x.dtype}; expected a non-empty [S_l, cols] "
                         "int32 or int8")
    me, group = meshmod.axis_group(axis)
    if group.p != p or p > MAX_SHARDS:
        raise ValueError(f"ring_exchange: p={p} on an axis of {group.p} "
                         f"shards (at most {MAX_SHARDS})")
    if x.device.type == "cpu":
        _, outs = group.rendezvous(me, x, _ring_exchange_plain)
        return outs[me]
    if not x.is_cuda:
        raise ValueError(f"ring_exchange: unsupported device {x.device}")

    x = x.contiguous()
    if group.ring is None:
        with _LOCK:
            if group.ring is None:
                group.ring = _RingState(p)
    state = group.ring
    stream = torch.cuda.current_stream(x.device)
    out = torch.empty((x.shape[0], p * x.shape[1]), dtype=x.dtype,
                      device=x.device)
    ready = torch.cuda.Event()
    ready.record(stream)
    item = {"x": x, "out": out, "ready": ready, "stream": stream,
            "raw": stream.cuda_stream}

    def leader(items):
        shapes = {(tuple(it["x"].shape), it["x"].dtype) for it in items}
        if len(shapes) != 1:
            raise ValueError(f"ring_exchange: shards disagree on the chunk: "
                             f"{sorted(map(str, shapes))}")
        return _launch_all(state, items)

    _, events = group.rendezvous(me, item, leader)
    # x stays alive until here; its memory is reused on this stream only
    # after the launch that read it
    if events[me] is not None:
        stream.wait_event(events[me])
    return out


def make_ring_gather(axis: str, p: int) -> Callable:
    """A drop-in for ``all_gather(x, axis, dim=1)`` over the hand-written
    exchange: ``[S_l, n_l, *F] -> [S_l, p * n_l, *F]`` (trailing feature
    dims ride flattened into the columns).  p == 1 shards are the identity
    — no kernel, no copy (round_tpu/parallel/ici.py::make_ring_gather)."""

    def gather(x):
        if p == 1:
            return x
        S_l, n_l = x.shape[0], x.shape[1]
        full = ring_exchange(x.reshape(S_l, -1), axis=axis, p=p)
        return full.reshape((S_l, p * n_l) + tuple(x.shape[2:]))

    return gather


def ring_bytes_per_round(S_l: int, n_l: int, p: int, itemsize: int,
                         exchanges_per_round: int = 1) -> int:
    """Bytes one device sends to other devices in one round of the
    exchange: p-1 remote copies of the [S_l, n_l] chunk (the local slot
    write stays on the device;
    round_tpu/parallel/ici.py::ring_bytes_per_round)."""
    return (p - 1) * S_l * n_l * itemsize * exchanges_per_round


# ---------------------------------------------------------------------------
# The family table: every sharded dryrun family, both exchange paths
# ---------------------------------------------------------------------------

FAMILIES = ("hist", "benor", "tpc", "erb", "lattice")


def _family_runner(family: str, n: int, S: int, rounds: int,
                   gen: torch.Generator, device):
    """(state0, mix, run_fn) for one proc-sharded family, where
    ``run_fn(state0, mix, mesh, exchange, pipelined)`` executes it, all
    drawn from `gen` on `device`.  The SAME constructors back the parity
    tests, the status line and chip_smoke.py, so they cannot check
    different programs (round_tpu/parallel/ici.py::_family_runner)."""
    from round_tpu_torch.engine import fast

    dev = torch.device(device)

    def mix_of(**kw):
        return fast.standard_mix(gen, S, n, device=dev, **kw)

    if family == "hist":
        from round_tpu_torch.models.otr import OtrState

        V = 4
        mix = mix_of(p_drop=0.25)
        init = torch.randint(0, V, (n,), generator=gen, dtype=torch.int32,
                             device=dev)
        rnd = fast.OtrHist(n_values=V, after_decision=2)
        state0 = OtrState.fresh(init, S, n)

        def run(state0, mix, mesh, exchange, pipelined):
            return meshmod.run_hist_proc_sharded(
                rnd, state0, mix, rounds, mesh, exchange=exchange,
                pipelined=pipelined)

        return state0, mix, run
    if family == "benor":
        from round_tpu_torch.models.benor import BenOrState

        mix = mix_of(p_drop=0.15)
        init = torch.rand((n,), generator=gen, device=dev) < 0.5
        rnd = fast.BenOrHist()
        state0 = BenOrState.fresh(init, S, n)

        def run(state0, mix, mesh, exchange, pipelined):
            return meshmod.run_hist_proc_sharded(
                rnd, state0, mix, rounds, mesh, exchange=exchange,
                pipelined=pipelined)

        return state0, mix, run
    if family == "tpc":
        from round_tpu_torch.models.tpc import TpcState

        mix = mix_of(p_drop=0.25, f=max(1, n // 4), crash_round=0)
        votes = torch.rand((n,), generator=gen, device=dev) < 0.8
        state0 = TpcState.fresh(0, votes, S, n)

        def run(state0, mix, mesh, exchange, pipelined):
            return meshmod.run_tpc_proc_sharded(
                state0, mix, mesh, exchange=exchange, pipelined=pipelined)

        return state0, mix, run
    if family == "erb":
        from round_tpu_torch.models.erb import ErbState, broadcast_io

        V = 8
        mix = mix_of(p_drop=0.25, f=max(1, n // 4), crash_round=0)
        state0 = ErbState.fresh(broadcast_io(0, 5, n, device=dev), S, n)

        def run(state0, mix, mesh, exchange, pipelined):
            return meshmod.run_erb_proc_sharded(
                state0, mix, mesh, rounds, V, exchange=exchange,
                pipelined=pipelined)

        return state0, mix, run
    if family == "lattice":
        from round_tpu_torch.models.lattice import LatticeState, lattice_io

        m = 10
        mix = mix_of(p_drop=0.2)
        sets = [[i % m, (5 * i + 2) % m] for i in range(n)]
        io = lattice_io(sets, m, device=dev)
        state0 = LatticeState.fresh(io["initial_value"], S, n)

        def run(state0, mix, mesh, exchange, pipelined):
            return meshmod.run_lattice_proc_sharded(
                state0, mix, mesh, rounds, exchange=exchange,
                pipelined=pipelined)

        return state0, mix, run
    raise ValueError(f"unknown ici family {family!r}")


def single_device_run(family: str, state0, mix, rounds: int):
    """The family's single-device fast runner in hash mode, on the device
    of `state0`: what every sharded run of `_family_runner` must equal."""
    from round_tpu_torch.engine import fast

    if family == "hist":
        return fast.run_hist(fast.OtrHist(n_values=4, after_decision=2),
                             state0, lambda s: s.decided, mix, rounds,
                             mode="hash")
    if family == "benor":
        return fast.run_hist(fast.BenOrHist(), state0, lambda s: s.decided,
                             mix, rounds, mode="hash")
    if family == "tpc":
        return fast.run_tpc_fast(state0, mix, mode="hash")
    if family == "erb":
        return fast.run_erb_fast(state0, mix, rounds, 8, mode="hash")
    if family == "lattice":
        return fast.run_lattice_fast(state0, mix, rounds)
    raise ValueError(f"unknown ici family {family!r}")


def _trees_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _mesh_for(proc_shards: int, devices):
    devs = list(devices) if devices is not None else meshmod._visible_devices()
    return meshmod.make_mesh(len(devs), proc_shards=proc_shards,
                             devices=devs)


def family_parity(family: str, *, n: int = 16, S: int = 8,
                  proc_shards: int = 2, rounds: int = 6, seed: int = 3,
                  pipelined: bool = True, devices=None) -> bool:
    """Raw-bit tree equality of the ici exchange against the collective
    path for one family on a mesh over `devices` (default: every visible
    CUDA device) — the ``_assert_tree_parity`` discipline as a predicate
    (round_tpu/parallel/ici.py::family_parity)."""
    mesh = _mesh_for(proc_shards, devices)
    dev = mesh.devices.flat[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    state0, mix, run = _family_runner(family, n, S, rounds, gen, dev)
    ref = run(state0, mix, mesh, "collective", False)
    got = run(state0, mix, mesh, "ici", pipelined)
    return _trees_equal(got, ref)


def exchange_bytes_report(*, n: int = 16, S: int = 8, proc_shards: int = 2,
                          rounds: int = 3, family: str = "hist",
                          devices=None) -> dict:
    """Bytes moved per device per round, ici against the library gather,
    for one family (round_tpu/parallel/ici.py::exchange_bytes_report).
    The collective side is what the port's ``all_gather`` really moved in a
    run of the family, counted at the call (the bytes of each call's
    result, as round_tpu counts its all-gathers' results), over the shards
    and the rounds that exchanged; the ici side is
    ``ring_bytes_per_round``.  The gate: ici moves at most the (p-1)/p
    remote fraction of the full-tensor gather."""
    mesh = _mesh_for(proc_shards, devices)
    dev = mesh.devices.flat[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    state0, mix, run = _family_runner(family, n, S, rounds, gen, dev)
    meshmod.reset_collective()
    run(state0, mix, mesh, "collective", False)
    moved = dict(meshmod.COLLECTIVE)
    coll = moved["bytes"] // max(1, moved["rounds"])

    S_l = S // mesh.shape[meshmod.SCENARIO_AXIS]
    n_l = n // proc_shards
    # per round the ici path exchanges ONE packed tensor: int32 codes for
    # the histogram families, int8 (active | bit-planes) for lattice
    if family == "lattice":
        m = state0.proposed.shape[-1]
        ici = ring_bytes_per_round(S_l, n_l * (m + 1), proc_shards, 1)
    else:
        ici = ring_bytes_per_round(S_l, n_l, proc_shards, 4)
    bound = (proc_shards - 1) / proc_shards
    ratio = ici / coll if coll else float("inf")
    return {
        "family": family,
        "n": n, "S": S, "proc_shards": proc_shards,
        "collective_bytes_per_round": coll,
        "collective_calls": moved["calls"],
        "ici_bytes_per_round": ici,
        "ratio": round(ratio, 4),
        "bound": round(bound, 4),
        "ok": coll > 0 and ratio <= bound + 1e-9,
    }


# ---------------------------------------------------------------------------
# The status probe: one JSON line
# ---------------------------------------------------------------------------

def status(*, n: int = 64, S: int = 16, proc_shards: int = 2,
           rounds: int = 4, devices=None, stage_fn=None) -> dict:
    """The status line of the hand-written exchange: parity of the hist
    family against the library gather, the bytes ratio, and the evidence
    that the ici path ran the kernel and no library gather (K4's launches
    and the count of ``all_gather`` calls in an ici run; on CPU devices the
    plain version runs and the launches stay 0).  ``stage_fn(name)``
    narrates progress so a hang names its stage
    (round_tpu/parallel/ici.py::status)."""
    def stage(s):
        if stage_fn:
            stage_fn(s)

    out: dict = {"n": n, "S": S, "proc_shards": proc_shards}
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    devices = [torch.device(d) for d in devices]
    out["devices"] = [str(d) for d in devices]
    if len(devices) < 2 or len(devices) % proc_shards:
        # a skipped STATUS line, never a bare make_mesh error: a one-card
        # machine must still give a parseable record
        out["skipped"] = (f"needs a device count divisible by "
                          f"proc_shards={proc_shards} and >= 2, have "
                          f"{len(devices)} (pass the list, a device may "
                          "repeat)")
        return out
    stage("ici-parity")
    out["parity"] = family_parity("hist", n=n, S=S, proc_shards=proc_shards,
                                  rounds=rounds, devices=devices)
    stage("ici-bytes")
    rep = exchange_bytes_report(n=n, S=S, proc_shards=proc_shards,
                                rounds=rounds, devices=devices)
    out["bytes"] = {k: rep[k] for k in
                    ("collective_bytes_per_round", "ici_bytes_per_round",
                     "ratio", "bound", "ok")}
    stage("ici-launches")
    mesh = _mesh_for(proc_shards, devices)
    dev = mesh.devices.flat[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    state0, mix, run = _family_runner("hist", n, S, rounds, gen, dev)
    before = LAUNCHES["ring_exchange"]
    meshmod.reset_collective()
    run(state0, mix, mesh, "ici", True)
    rings = mesh.shape[meshmod.SCENARIO_AXIS]
    out["launches"] = {
        "ring_exchange": LAUNCHES["ring_exchange"] - before,
        "all_gather_calls": meshmod.COLLECTIVE["calls"],
        "expected_ring_exchange": (
            rounds * rings * len({d for d in mesh.devices[0]})
            if dev.type == "cuda" else 0),
    }
    launches_ok = (
        out["launches"]["all_gather_calls"] == 0
        and out["launches"]["ring_exchange"]
        == out["launches"]["expected_ring_exchange"])
    out["ok"] = bool(out["parity"] and out["bytes"]["ok"] and launches_ok)
    return out


def _main(argv=None) -> int:
    """``python -m round_tpu_torch.parallel.ici``: print the status line
    as one JSON object, narrating PROBE_STAGE markers on stderr.  The mesh
    takes every visible CUDA card, or the ``--devices`` list, in which a
    device may repeat (``--devices cuda:0,cuda:0,cuda:0,cuda:0``)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="python -m round_tpu_torch.parallel.ici")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the mesh, e.g. "
                         "cuda:0,cuda:0 or cpu,cpu (default: all CUDA cards)")
    ap.add_argument("--proc-shards", type=int, default=2)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--scenarios", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    def stage(s):
        sys.stderr.write("PROBE_STAGE " + s + "\n")
        sys.stderr.flush()

    stage("ici-import")
    devices = args.devices.split(",") if args.devices else None
    res = status(n=args.n, S=args.scenarios, proc_shards=args.proc_shards,
                 rounds=args.rounds, devices=devices, stage_fn=stage)
    print(json.dumps(res), flush=True)
    return 0 if res.get("ok") or "skipped" in res else 1


if __name__ == "__main__":
    raise SystemExit(_main())
