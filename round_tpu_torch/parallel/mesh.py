"""Multi-device execution: shard the scenario and process axes over a mesh.

Port of round_tpu/parallel/mesh.py.  round_tpu scales over a
jax.sharding.Mesh with two axes:

  - 'scenario': pure data parallelism over fault scenarios — no traffic
    between devices at all (each device simulates its own slice of the
    HO-scenario batch).
  - 'proc': the process axis of the simulated group is sharded — each
    device owns n/p lanes.  One round then needs the sent payloads (and
    active/dest masks) of *all* senders at every receiver's device: one
    gather over 'proc' per round.  This is the framework's collective
    "network".

The execution model is JAX's own, written out: ONE controlling process
holds a (scenario × proc) grid of ``torch.device``s, in which the same
device may appear more than once (four shards on ``cuda:0`` run the same
code, kernels and remote writes as four cards, the peers' buffers just
happen to lie on the same card).  ``shard_map`` splits the global tensors
by their specs, runs the body once per mesh position — one thread and, on a
card, one CUDA stream each; ``axis_index`` reads the thread's position —
and reassembles the outputs.  Inside a body the collectives are rendezvous
of the axis' threads: ``all_gather`` (library copies, the "collective"
control) and ``parallel.ici.ring_exchange`` (the hand-written kernel).

The round/phase semantics are NOT duplicated here: this module supplies a
ProcShardTopology (where lanes live + how to gather) and runs the shared
engine cores (engine.executor.run_phases, engine.fast.hist_scan) inside
shard_map.  Sharded and single-device execution are bit-identical: the HO
block of a shard is regenerated at GLOBAL receiver ids, coins and lane
keys take global lane ids, counts are exact int32 sums.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.engine.executor import (
    LocalTopology, init_lanes, run_phases,
)
from round_tpu_torch.utils.tree import tree_map, tree_stack

SCENARIO_AXIS = "scenario"
PROC_AXIS = "proc"

#: what the library gather moved: calls of ``all_gather`` and the bytes of
#: their results, summed over every shard, and the rounds in which a
#: proc-sharded runner exchanged (summed over shards too)
COLLECTIVE: Dict[str, int] = {"calls": 0, "bytes": 0, "rounds": 0}
_COUNT_LOCK = threading.Lock()


def reset_collective() -> None:
    for k in COLLECTIVE:
        COLLECTIVE[k] = 0


def _count(**inc) -> None:
    with _COUNT_LOCK:
        for k, v in inc.items():
            COLLECTIVE[k] += v


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading tensor
    dimension, as jax.sharding.PartitionSpec.  ``P("scenario", "proc")``
    cuts dim 0 over the scenario axis and dim 1 over the proc axis;
    dimensions not named are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Mesh:
    """A grid of ``torch.device``s with named axes, held by one process.
    A device may appear at several positions."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs "
                f"{self.devices.ndim} axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @classmethod
    def line(cls, devices, axis_name: str) -> "Mesh":
        """A one-axis mesh over `devices`, in order."""
        grid = np.empty((len(devices),), dtype=object)
        grid[:] = [torch.device(d) for d in devices]
        return cls(grid, (axis_name,))


def _visible_devices():
    from round_tpu_torch.utils.device import resolve_device

    resolve_device(None)  # raises where there is no card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, proc_shards: int = 1,
              devices=None) -> Mesh:
    """A (scenario × proc) mesh over `devices` (default: every visible CUDA
    device; round_tpu/parallel/mesh.py::make_mesh).  Raises when `devices`
    holds fewer than `n_devices`: a caller that wants several shards on one
    card passes the list, ``[torch.device("cuda:0")] * 4``."""
    devs = list(devices) if devices is not None else _visible_devices()
    devs = [torch.device(d) for d in devs]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"want {n_devices} devices, have {len(devs)}")
    if n_devices < 1 or n_devices % proc_shards:
        raise ValueError(f"{n_devices} devices do not split into "
                         f"proc_shards={proc_shards}")
    line = Mesh.line(devs[:n_devices], SCENARIO_AXIS)
    return Mesh(line.devices.reshape(n_devices // proc_shards, proc_shards),
                (SCENARIO_AXIS, PROC_AXIS))


# ---------------------------------------------------------------------------
# shard_map: one thread per mesh position, rendezvous collectives
# ---------------------------------------------------------------------------

class _Group:
    """The threads of one mesh axis that share every other coordinate: the
    parties of that axis' collectives."""

    def __init__(self, p: int):
        self.p = p
        self.barrier = threading.Barrier(p)
        self.slots = [None] * p
        self.result = None
        self.ring = None  # parallel.ici's state of this ring (flags, epoch)

    def rendezvous(self, me: int, item, leader_fn: Optional[Callable] = None):
        """Every party hands in `item`; returns (the items in axis order,
        what ``leader_fn(items)`` returned in the one thread that ran it).
        A party that fails aborts the barrier, so the others raise
        BrokenBarrierError instead of waiting."""
        self.slots[me] = item
        first = self.barrier.wait() == 0
        if leader_fn is not None:
            if first:
                self.result = leader_fn(list(self.slots))
            self.barrier.wait()
        items, result = list(self.slots), self.result
        self.barrier.wait()  # all have read: the slots may be written again
        return items, result


class _Run:
    """One invocation of a shard_map'd function: its groups and failures."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.lock = threading.Lock()
        self.groups: Dict[tuple, _Group] = {}
        self.failed = False

    def group(self, axis: str, coords: Dict[str, int]) -> _Group:
        key = (axis,) + tuple(coords[a] for a in self.mesh.axis_names
                              if a != axis)
        with self.lock:
            g = self.groups.get(key)
            if g is None:
                g = self.groups[key] = _Group(self.mesh.shape[axis])
                if self.failed:
                    g.barrier.abort()
            return g

    def abort(self) -> None:
        with self.lock:
            self.failed = True
            for g in self.groups.values():
                g.barrier.abort()


class _Shard:
    def __init__(self, run: _Run, coords: Dict[str, int], device):
        self.run = run
        self.coords = coords
        self.device = device


_TLS = threading.local()


def _shard() -> _Shard:
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        raise RuntimeError("this call must run inside shard_map")
    return sh


def axis_index(axis: str) -> int:
    """This shard's position along mesh axis `axis` (jax.lax.axis_index)."""
    return _shard().coords[axis]


def shard_device() -> torch.device:
    """The device of the mesh position this thread runs."""
    return _shard().device


def axis_group(axis: str):
    """(this shard's index along `axis`, the _Group of that axis'
    collectives at this shard's other coordinates)."""
    sh = _shard()
    return sh.coords[axis], sh.run.group(axis, sh.coords)


def all_gather(x: torch.Tensor, axis: str, dim: int = 1) -> torch.Tensor:
    """Every shard's `x` along mesh axis `axis`, concatenated on dimension
    `dim` in axis order, on this shard's device — the library collective
    (``torch.cat`` of ``.to(device)`` copies), in the role of
    ``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``.  A rendezvous of
    the axis' threads; each call and the bytes of its result are counted in
    ``COLLECTIVE``."""
    me, group = axis_group(axis)
    ready = None
    if x.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
    items, _ = group.rendezvous(me, (x, ready))
    dev = x.device
    chunks = []
    for chunk, ev in items:
        if ev is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ev)
            # the peer may drop its chunk while this stream still reads it
            chunk.record_stream(stream)
        chunks.append(chunk.to(dev, non_blocking=True))
    out = torch.cat(chunks, dim=dim)
    _count(calls=1, bytes=out.numel() * out.element_size())
    return out


def _cut(leaf: torch.Tensor, spec: P, coords, mesh: Mesh, device):
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        parts = mesh.shape[axis]
        if leaf.shape[d] % parts:
            raise ValueError(
                f"dimension {d} of size {leaf.shape[d]} does not split over "
                f"the {parts} shards of axis {axis!r}")
        size = leaf.shape[d] // parts
        leaf = leaf.narrow(d, coords[axis] * size, size)
    return leaf.to(device).contiguous()


def _split(arg, spec, coords, mesh: Mesh, device):
    if isinstance(spec, P):
        return tree_map(lambda leaf: _cut(leaf, spec, coords, mesh, device),
                        arg)
    return type(arg)(_split(a, s, coords, mesh, device)
                     for a, s in zip(arg, spec))


def _join(leaves, spec: P, mesh: Mesh, device):
    """One global leaf from the leaves of every mesh position (row-major)."""
    grid = np.empty(mesh.devices.shape, dtype=object)
    for pos, leaf in zip(np.ndindex(*mesh.devices.shape), leaves):
        grid[pos] = leaf

    def rec(prefix):
        depth = len(prefix)
        if depth == grid.ndim:
            return grid[prefix].to(device)
        axis = mesh.axis_names[depth]
        if axis not in spec:
            return rec(prefix + (0,))  # replicated along this axis
        return torch.cat([rec(prefix + (i,))
                          for i in range(grid.shape[depth])],
                         dim=spec.index(axis))

    return rec(())


def _assemble(parts, spec, mesh: Mesh, device):
    if isinstance(spec, P):
        flat = [pytree.tree_flatten(part) for part in parts]
        leaves = [_join([f[0][i] for f in flat], spec, mesh, device)
                  for i in range(len(flat[0][0]))]
        return pytree.tree_unflatten(leaves, flat[0][1])
    return type(parts[0])(
        _assemble([part[i] for part in parts], s, mesh, device)
        for i, s in enumerate(spec))


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map`` for a mesh held by one process: the returned
    function cuts its (global) arguments by `in_specs` — a ``P`` applies to
    every leaf of its argument —, runs ``fn`` once per mesh position, each
    in a thread of its own and, on a card, a CUDA stream of its own, and
    joins the results by `out_specs` on the mesh's first device.  Streams
    start after the caller's current stream and are synchronised before the
    results are joined.  A shard that raises releases the others'
    rendezvous; its exception is raised in the caller."""

    def run(*args):
        state = _Run(mesh)
        positions = list(np.ndindex(*mesh.devices.shape))
        outs = [None] * len(positions)
        errors = [None] * len(positions)
        caller_streams = {
            dev: torch.cuda.current_stream(dev)
            for dev in set(mesh.devices.flat) if dev.type == "cuda"}

        def body(k, pos):
            device = mesh.devices[pos]
            coords = dict(zip(mesh.axis_names, pos))
            _TLS.shard = _Shard(state, coords, device)
            try:
                def call():
                    local = [_split(a, s, coords, mesh, device)
                             for a, s in zip(args, in_specs)]
                    return fn(*local)

                if device.type == "cuda":
                    stream = torch.cuda.Stream(device)
                    stream.wait_stream(caller_streams[device])
                    with torch.cuda.device(device), torch.cuda.stream(stream):
                        outs[k] = call()
                    stream.synchronize()
                else:
                    outs[k] = call()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors[k] = exc
                state.abort()
            finally:
                _TLS.shard = None

        threads = [threading.Thread(target=body, args=(k, pos), daemon=True)
                   for k, pos in enumerate(positions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            # the shard that failed, not the peers its failure released
            real = [e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or failed)[0]
        from round_tpu_torch.parallel import ici

        for group in state.groups.values():
            ici.check_ring(group)
        return _assemble(outs, out_specs, mesh, mesh.devices.flat[0])

    return run


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _assert_tree_parity(got, want, msg: str) -> None:
    """THE dryrun parity assertion: every leaf bit-identical
    (round_tpu/parallel/mesh.py::_assert_tree_parity)."""
    a, b = pytree.tree_leaves(got), pytree.tree_leaves(want)
    _check(len(a) == len(b), msg)
    for x, y in zip(a, b):
        _check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), msg)


def sharded_keyed_parity(one_fn: Callable, keys, n_devices: int,
                         devices=None):
    """Run a per-scenario keyed computation scenario-sharded over an
    n_devices mesh AND on the mesh's first device alone, returning
    (run, sharded_outputs, raw_bit_parity) — `run` is the shard_map'd
    callable, so a caller can time the very computation whose parity was
    just pinned (round_tpu/parallel/mesh.py::sharded_keyed_parity).

    one_fn: (salt0, salt1) key -> tuple of tensors (one scenario's outputs,
            on the device it is called on: ``shard_device()``).
    keys:   [S, 2] integer tensor of scenario keys, S divisible by
            n_devices."""
    keys = torch.as_tensor(keys)
    if keys.shape[0] % n_devices:
        raise ValueError(f"{keys.shape[0]} keys over {n_devices} devices")
    devs = list(devices) if devices is not None else _visible_devices()
    if n_devices > len(devs):
        raise ValueError(f"want {n_devices} devices, have {len(devs)}")
    mesh = Mesh.line(devs[:n_devices], SCENARIO_AXIS)

    def batch(keys_l):
        return tree_stack([tuple(one_fn((int(k[0]), int(k[1]))))
                           for k in keys_l.cpu()])

    run = shard_map(batch, mesh, in_specs=(P(SCENARIO_AXIS),),
                    out_specs=P(SCENARIO_AXIS))
    sharded = run(keys)
    single = shard_map(batch, Mesh.line(devs[:1], SCENARIO_AXIS),
                       in_specs=(P(SCENARIO_AXIS),),
                       out_specs=P(SCENARIO_AXIS))(keys)
    parity = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                 zip(pytree.tree_leaves(sharded), pytree.tree_leaves(single)))
    return run, sharded, parity


class ProcShardTopology(LocalTopology):
    """Lane slice of one device when the process axis is sharded over
    PROC_AXIS (round_tpu/parallel/mesh.py::ProcShardTopology).

    Gathers are the library ``all_gather``; HO rows / dest columns are
    sliced to the local receivers.  Per-lane rng words are hashed from the
    GLOBAL lane ids, so the schedule matches LocalTopology exactly."""

    def __init__(self, n: int, n_shards: int, device=None):
        super().__init__(n, device)
        self.n_shards = n_shards
        self.n_local = n // n_shards

    def _offset(self) -> int:
        return axis_index(PROC_AXIS) * self.n_local

    def lane_ids(self) -> torch.Tensor:
        return self._offset() + torch.arange(
            self.n_local, dtype=torch.int32, device=self.device)

    def gather(self, tree: Any) -> Any:
        return tree_map(lambda x: all_gather(x, PROC_AXIS, dim=0), tree)

    def ho_rows(self, ho: torch.Tensor) -> torch.Tensor:
        return ho.narrow(0, self._offset(), self.n_local).to(self.device)

    def dest_cols(self, dest: torch.Tensor) -> torch.Tensor:
        return dest.narrow(1, self._offset(), self.n_local).T


def sharded_simulate(
    algo: Algorithm,
    io: Any,
    n: int,
    key,
    ho_sampler,
    max_phases: int,
    n_scenarios: int,
    mesh: Mesh,
):
    """Run the full batched simulation sharded over `mesh`
    (round_tpu/parallel/mesh.py::sharded_simulate).

    io leaves must be [S, n, ...]; returns (state [S, n, ...], done,
    decided_round) with the same values as engine.executor.simulate on one
    device with the same key: scenario s runs under the key
    ``(mix32(salt0 + s·GOLD), salt1)``, as there (round_tpu splits a
    threefry key instead; its draws are never bit-compared).  `ho_sampler`
    draws the full [n, n] mask and each shard keeps its receiver rows."""
    from round_tpu_torch.engine.scenarios import _key_salt, mix32_host
    from round_tpu_torch.ops.fused import _GOLD

    s_shards = mesh.shape[SCENARIO_AXIS]
    p_shards = mesh.shape[PROC_AXIS]
    if n_scenarios % s_shards or n % p_shards:
        raise ValueError(f"S={n_scenarios}, n={n} do not split over the "
                         f"mesh {mesh.shape}")
    k0, k1 = _key_salt(key)
    keys = torch.tensor([[mix32_host(k0 + s * _GOLD), k1]
                         for s in range(n_scenarios)], dtype=torch.int64)
    spec = P(SCENARIO_AXIS, PROC_AXIS)

    def run(io_l, keys_l):
        topo = ProcShardTopology(n, p_shards, shard_device())
        results = []
        for s, k in enumerate(keys_l.cpu()):
            io_s = tree_map(lambda leaf: leaf[s], io_l)
            state0 = init_lanes(algo, io_s, n, topo)
            state, done, decided_round, _ = run_phases(
                algo, state0, (int(k[0]), int(k[1])), ho_sampler, max_phases,
                topo)
            results.append((state, done, decided_round))
        return tree_stack(results)

    io = tree_map(torch.as_tensor, io)
    return shard_map(run, mesh, in_specs=(spec, P(SCENARIO_AXIS)),
                     out_specs=(P(SCENARIO_AXIS, PROC_AXIS),) * 3)(io, keys)


def _ho_block(mix_l, r: int, jg: torch.Tensor, n: int) -> torch.Tensor:
    """This shard's HO mask block at GLOBAL (receiver jg, sender i) indices
    — the scenarios.from_fault_params formula row-sliced, through the ONE
    shared receiver-block helper (ops.exchange.ho_block, which the dense
    ops.fused.ho_link_mask is also an instance of).  Shared by every
    receiver-sharded counts_fn (round_tpu/parallel/mesh.py::_ho_block)."""
    from round_tpu_torch.engine import fast as _fast
    from round_tpu_torch.ops.exchange import ho_block

    colmask, side_r, p8, salt0, salt1r = _fast.round_params(mix_l, r)
    return ho_block(colmask, side_r, salt0, salt1r, p8, jg=jg)


def _resolve_exchange(exchange: str, pipelined):
    """Shared keyword policy of the proc-sharded runners: the library
    gather stays the default A/B control; ``exchange="ici"`` opts into the
    hand-written exchange, which defaults to the cross-round pipelined
    loop (straight-line stays selectable;
    round_tpu/parallel/mesh.py::_resolve_exchange)."""
    if exchange not in ("collective", "ici"):
        raise ValueError(f"unknown exchange {exchange!r}; "
                         "want 'collective' or 'ici'")
    if pipelined is None:
        pipelined = exchange == "ici"
    return exchange, pipelined


def _proc_mesh_sizes(mix, mesh: Mesh):
    s_shards = mesh.shape[SCENARIO_AXIS]
    p_shards = mesh.shape[PROC_AXIS]
    S, n = mix.crashed.shape
    if S % s_shards or n % p_shards:
        raise ValueError(f"S={S}, n={n} do not split over the mesh "
                         f"{mesh.shape}")
    return p_shards, n, n // p_shards


def run_hist_proc_sharded(
    rnd,
    state0,
    mix,
    max_rounds: int,
    mesh: Mesh,
    decided_fn=None,
    send_guard_fn=None,
    exchange: str = "collective",
    pipelined=None,
):
    """engine.fast.run_hist with the PROCESS axis sharded over PROC_AXIS
    (and scenarios over SCENARIO_AXIS): the fast histogram path for groups
    too large for one device's lanes
    (round_tpu/parallel/mesh.py::run_hist_proc_sharded).

    RECEIVERS are sharded — each device keeps its [S_l, n_l] state slice
    and, per round, gathers only the O(n) payload/active vectors, then
    computes its own [V, n] × [n, n_l] count block locally.  No [n, n] mask
    ever crosses a device: the HO mask block is regenerated per device from
    the FaultMix salts at GLOBAL (receiver, sender) indices (the same
    counter-based hash the fused kernels and scenarios.from_fault_params
    share), so the sharded run is BIT-IDENTICAL to run_hist(mode="hash") on
    the same mix — counts are exact int32 sums, order-free.

    state0 leaves are global [S, n, ...]; mix leaves [S] / [S, n] (the n
    axis of the mix replicates — it is O(n) metadata).  Returns
    (state, done, decided_round) with global shapes, on the mesh's first
    device.

    ``send_guard_fn(state_local, k) -> [S_l, n_l] bool`` marks which LOCAL
    lanes broadcast in subround k (guarded sends: TPC's coordinator rounds,
    ERB's defined-senders flooding).  The guard is gathered with the
    payload and ANDed into the delivery — this sharded formulation has NO
    hard-wired self-delivery to correct (the eye term is part of `ho` and
    the guard masks it like any sender), unlike the K2 path's
    subtract_self_delivery discipline.

    ``exchange="ici"`` swaps the two library gathers for ONE hand-written
    exchange of the packed sender code (parallel/ici.py), and defaults the
    round loop to the cross-round pipelined form (hist_scan ho_fn).  All
    four combinations are bit-identical."""
    from round_tpu_torch.engine import fast as _fast
    from round_tpu_torch.ops.exchange import (
        block_counts, hist_code_counts, hist_pack,
    )
    from round_tpu_torch.parallel import ici as _ici

    exchange, pipelined = _resolve_exchange(exchange, pipelined)
    if decided_fn is None:
        decided_fn = lambda s: s.decided  # noqa: E731
    p_shards, n, n_l = _proc_mesh_sizes(mix, mesh)
    V = rnd.num_values

    def run(state0_l, mix_l):
        dev = shard_device()
        jg = axis_index(PROC_AXIS) * n_l + torch.arange(
            n_l, dtype=torch.int32, device=dev)           # global receiver ids
        ring = _ici.make_ring_gather(PROC_AXIS, p_shards)
        rows = torch.arange(V, dtype=torch.int32, device=dev)[None, :, None]

        def counts_fn(state, k, done, r, ho=None):
            if k in rnd.no_exchange_subrounds:
                # the subround consumes no counts (TPC's prepare): skip
                # the gathers and the count entirely
                return torch.zeros((done.shape[0], V, done.shape[1]),
                                   dtype=torch.int32, device=dev)
            if ho is None:  # straight-line loop: mask generated in-round
                ho = _ho_block(mix_l, r, jg, n)
            _count(rounds=1)

            payload = rnd.payload(state, k)                # [S_l, n_l]
            # sender eligibility = active ∧ guard, fused into ONE gather
            # (deliver only ever uses the conjunction)
            sending = ~done if send_guard_fn is None \
                else (~done) & send_guard_fn(state, k)
            if exchange == "ici":
                # ONE packed wire tensor: silence is code 0, which matches
                # no histogram row — termwise equal to the two-gather
                # form, exact int32 sums either way
                code_full = ring(hist_pack(payload, sending))
                return hist_code_counts(code_full, ho, V)
            payload_full = all_gather(payload, PROC_AXIS, dim=1)  # [S_l, n]
            sending_full = all_gather(sending, PROC_AXIS, dim=1)  # [S_l, n]
            deliver = ho & sending_full[:, None, :]        # [S_l, n_l, n]
            oh = payload_full[:, None, :].to(torch.int32) == rows
            return block_counts(oh, deliver)               # [S_l, V, n_l]

        coin_fn = _fast.hash_coin_fn(mix_l, jg) if rnd.needs_coin else None
        ho_fn = (lambda r: _ho_block(mix_l, r, jg, n)) if pipelined else None
        return _fast.hist_scan(
            rnd, state0_l, decided_fn, max_rounds, n, counts_fn, coin_fn,
            lane_ids=jg, ho_fn=ho_fn)

    spec_state = P(SCENARIO_AXIS, PROC_AXIS)
    return shard_map(run, mesh, in_specs=(spec_state, P(SCENARIO_AXIS)),
                     out_specs=(spec_state,) * 3)(state0, mix)


def run_tpc_proc_sharded(state0, mix, mesh: Mesh, max_rounds: int = 3,
                         exchange: str = "collective", pipelined=None):
    """TPC on the proc-sharded fast path: the coordinator's guarded sends
    become a send_guard_fn (prepare/commit: only the coordinator's lane
    broadcasts, tested at its GLOBAL lane id).  Bit-identical to
    fast.run_tpc_fast on the same mix
    (round_tpu/parallel/mesh.py::run_tpc_proc_sharded)."""
    from round_tpu_torch.engine import fast as _fast

    def guard(state, k):
        n_l = state.coord.shape[1]
        lane = axis_index(PROC_AXIS) * n_l + torch.arange(
            n_l, dtype=state.coord.dtype, device=state.coord.device)
        is_coord = lane[None, :] == state.coord
        if k == 1:
            return torch.ones_like(is_coord)
        return is_coord

    return run_hist_proc_sharded(
        _fast.TpcHist(), state0, mix, max_rounds, mesh,
        decided_fn=lambda s: s.decided, send_guard_fn=guard,
        exchange=exchange, pipelined=pipelined,
    )


def run_lattice_proc_sharded(state0, mix, mesh: Mesh, max_rounds: int,
                             exchange: str = "collective", pipelined=None):
    """Lattice agreement on the receiver-sharded fast path: the bit-plane
    exchange gathers the full [n, m] proposal matrix (O(n·m) per round)
    and computes this device's Hamming-equality and OR-count blocks
    locally.  Bit-identical to fast.run_lattice_fast — counts are exact
    int32 sums (round_tpu/parallel/mesh.py::run_lattice_proc_sharded).

    ``exchange="ici"``: the active mask and the m proposal bit-planes ride
    ONE int8 exchange ([S_l, n_l, m+1] packed) instead of two library
    gathers; same pipelined/straight loop policy as
    run_hist_proc_sharded."""
    from round_tpu_torch.engine import fast as _fast
    from round_tpu_torch.parallel import ici as _ici

    exchange, pipelined = _resolve_exchange(exchange, pipelined)
    p_shards, n, n_l = _proc_mesh_sizes(mix, mesh)
    rnd = _fast.LatticeHist(state0.proposed.shape[-1])

    def run(state0_l, mix_l):
        jg = axis_index(PROC_AXIS) * n_l + torch.arange(
            n_l, dtype=torch.int32, device=shard_device())
        ring = _ici.make_ring_gather(PROC_AXIS, p_shards)

        def counts_fn(state, k, done, r, ho=None):
            if ho is None:
                ho = _ho_block(mix_l, r, jg, n)
            _count(rounds=1)
            if exchange == "ici":
                # active | bit-planes packed into one int8 wire tensor
                planes = torch.cat([(~done)[..., None], state.proposed],
                                   dim=-1)
                full = ring(planes.to(torch.int8))         # [S_l, n, m+1]
                active_full = full[..., 0] != 0
                P_full = full[..., 1:] != 0
            else:
                P_full = all_gather(state.proposed, PROC_AXIS, dim=1)
                active_full = all_gather(~done, PROC_AXIS, dim=1)
            deliver = ho & active_full[:, None, :]
            return _fast.lattice_counts(deliver, state.proposed, P_full)

        ho_fn = (lambda r: _ho_block(mix_l, r, jg, n)) if pipelined else None
        return _fast.hist_scan(
            rnd, state0_l, lambda s: s.decided, max_rounds, n, counts_fn,
            ho_fn=ho_fn)

    spec_state = P(SCENARIO_AXIS, PROC_AXIS)
    return shard_map(run, mesh, in_specs=(spec_state, P(SCENARIO_AXIS)),
                     out_specs=(spec_state,) * 3)(state0, mix)


def run_erb_proc_sharded(state0, mix, mesh: Mesh, max_rounds: int,
                         n_values: int, exchange: str = "collective",
                         pipelined=None):
    """ERB on the proc-sharded fast path: the defined-senders flooding
    guard gathers with the payload.  Bit-identical to fast.run_erb_fast on
    the same mix (protocol-generated runs;
    round_tpu/parallel/mesh.py::run_erb_proc_sharded)."""
    from round_tpu_torch.engine import fast as _fast

    return run_hist_proc_sharded(
        _fast.ErbHist(n_values), state0, mix, max_rounds, mesh,
        decided_fn=lambda s: s.delivered,
        send_guard_fn=lambda s, k: s.x_def,
        exchange=exchange, pipelined=pipelined,
    )


def sharded_hist_loop(
    algo,
    x0: torch.Tensor,
    mix,
    rounds: int,
    mesh: Mesh,
    mode: str = "hw",
    dot: str = "i8",
):
    """The flagship engine on the mesh: the whole-run loop kernel
    (ops.fused.hist_loop, K1) sharded over SCENARIO_AXIS — pure data
    parallelism, no traffic between devices (each device's launch
    simulates its own slice of the FaultMix batch;
    round_tpu/parallel/mesh.py::sharded_hist_loop).

    Returns exactly hist_loop's (state_arrays, done, decided_round) with
    bit-identical values to a single-device run on the same mix, in hash
    and in hw mode: the Philox key of a link is its scenario's."""
    from round_tpu_torch.engine.fast import _mix_args
    from round_tpu_torch.ops import fused as _fused

    s_shards = mesh.shape[SCENARIO_AXIS]
    if x0.shape[0] % s_shards:
        raise ValueError(f"S={x0.shape[0]} does not split over "
                         f"{s_shards} scenario shards")

    def run(*args):
        return _fused.hist_loop(algo, *args, rounds=rounds, mode=mode,
                                dot=dot)

    spec = P(SCENARIO_AXIS)
    return shard_map(
        run, mesh, in_specs=(spec,) * 9,
        out_specs=((spec,) * algo.n_state, spec, spec),
    )(x0, *_mix_args(mix))


def dryrun(n_devices: int, devices=None) -> None:
    """Execute one tiny run of every sharded path over an n_devices mesh
    (scenario × proc sharding) and hold each against its single-device
    run, bit for bit (round_tpu/parallel/mesh.py::dryrun).  `devices`
    defaults to the visible CUDA cards and raises when they are fewer than
    `n_devices`; pass ``[torch.device("cuda:0")] * n_devices`` for several
    shards on one card, or CPU devices for the plain versions.

    Segments: the general engine (sharded_simulate), the scenario-sharded
    whole-run loop kernel, the proc-sharded fast path through the library
    gather, the same through the hand-written exchange, the guarded-send
    path (TPC), the count-rank ε-agreement engine (dryrun_eps) and the
    PBFT view-change engine (dryrun_pbft_vc)."""
    from round_tpu_torch.engine import fast, scenarios
    from round_tpu_torch.engine.executor import simulate
    from round_tpu_torch.models.otr import OTR, OtrState
    from round_tpu_torch.models.tpc import TpcState
    from round_tpu_torch.ops import fused

    devs = list(devices) if devices is not None else _visible_devices()
    devs = [torch.device(d) for d in devs]
    if len(devs) < n_devices:
        raise RuntimeError(f"dryrun wants {n_devices} devices, have "
                           f"{len(devs)}")
    dev0 = devs[0]
    proc_shards = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, proc_shards=proc_shards, devices=devs)
    s_shards = n_devices // proc_shards
    shape = dict(mesh.shape)

    n = max(8, 4 * proc_shards)
    S = 2 * s_shards
    algo = OTR()
    init = (torch.arange(n, dtype=torch.int32, device=dev0) % 3).expand(
        S, n).contiguous()
    io = {"initial_value": init}
    sampler = scenarios.full(n, device=dev0)
    got = sharded_simulate(algo, io, n, (0, 0), sampler, max_phases=3,
                           n_scenarios=S, mesh=mesh)
    ref = simulate(algo, io, n, (0, 0), sampler, max_phases=3, n_scenarios=S,
                   io_batched=True, device=dev0)
    _assert_tree_parity(got, (ref.state, ref.done, ref.decided_round),
                        "sharded general engine diverged from single-device")
    _check(bool(got[1].all()), "OTR on a full network must terminate")
    print(f"dryrun_multichip ok: mesh={shape} n={n} scenarios={S} "
          f"decided_round_p50={float(got[2].float().median())}")

    loop_mesh = Mesh.line(devs[:n_devices], SCENARIO_AXIS)
    S2, n2, V2, rounds2 = 2 * n_devices, 16, 8, 6
    gen = torch.Generator(device=dev0).manual_seed(7)
    mix = fast.standard_mix(gen, S2, n2, p_drop=0.2, f=3, crash_round=1,
                            device=dev0)
    x0 = (torch.arange(n2, dtype=torch.int32, device=dev0) % V2).expand(
        S2, n2).contiguous()
    algo_loop = fused.OtrLoop(num_values=V2, after_decision=2)
    sharded = sharded_hist_loop(algo_loop, x0, mix, rounds=rounds2,
                                mesh=loop_mesh, mode="hash")
    single = fused.hist_loop(algo_loop, x0, *fast._mix_args(mix),
                             rounds=rounds2, mode="hash")
    _assert_tree_parity(sharded, single,
                        "sharded loop kernel diverged from single-device")
    dec = sharded[0][1]  # decided slot of OtrLoop state
    _check(int(dec.sum()) > 0, "loop-kernel dryrun decided nothing")
    print(f"dryrun_multichip loop-engine ok: engine=loop scenario-sharded "
          f"over {n_devices} devices, n={n2} scenarios={S2}, bit-parity vs "
          f"single-device exact, decided_lanes={int(dec.sum())}/{S2 * n2}")

    n4, S4, V4, r4 = 16, 2 * s_shards, 4, 6
    gen4 = torch.Generator(device=dev0).manual_seed(13)
    mix4 = fast.standard_mix(gen4, S4, n4, p_drop=0.2, device=dev0)
    init4 = torch.randint(0, V4, (n4,), generator=gen4, dtype=torch.int32,
                          device=dev0)
    rnd4 = fast.OtrHist(n_values=V4, after_decision=2)
    st4 = OtrState.fresh(init4, S4, n4)
    ref4 = fast.run_hist(rnd4, st4, lambda s: s.decided, mix4, max_rounds=r4,
                         mode="hash")
    got4 = run_hist_proc_sharded(rnd4, st4, mix4, r4, mesh)
    _assert_tree_parity(got4, ref4,
                        "proc-sharded fast path diverged from single-device")
    print(f"dryrun_multichip proc-sharded fast path ok: receiver-sharded "
          f"count blocks over mesh {shape}, bit-parity vs single-device")

    got4i = run_hist_proc_sharded(rnd4, st4, mix4, r4, mesh, exchange="ici")
    _assert_tree_parity(got4i, ref4,
                        "ici exchange diverged from single-device")
    print(f"dryrun_multichip ici arm ok: hand-written exchange (packed "
          f"sender codes, pipelined HO carry) over mesh {shape}, bit-parity "
          f"vs single-device")

    gen5 = torch.Generator(device=dev0).manual_seed(17)
    votes5 = torch.rand((n4,), generator=gen5, device=dev0) < 0.8
    st5 = TpcState.fresh(0, votes5, S4, n4)
    ref5 = fast.run_tpc_fast(st5, mix4, max_rounds=3, mode="hash")
    got5 = run_tpc_proc_sharded(st5, mix4, mesh)
    _assert_tree_parity(got5, ref5,
                        "guarded-send sharded path diverged from "
                        "single-device")
    _check(bool(got5[0].decided.any()),
           "guarded-send dryrun decided nothing")
    print("dryrun_multichip guarded-send sharded path ok: TPC coordinator "
          "guard gathered with the payload, bit-parity vs single-device")
    dryrun_eps(n_devices, devs)
    dryrun_pbft_vc(n_devices, devs)


def dryrun_eps(n_devices: int, devices=None) -> None:
    """The dry run's ε segment (round_tpu/parallel/mesh.py::_dryrun_cpu,
    the eps-fused part): the count-rank ε-agreement engine
    (engine/epsfast.py) scenario-sharded over an n_devices line mesh
    through sharded_keyed_parity — the harness the ladder's ε rung uses —
    raw-bit against the mesh's first device alone, n=16, f=2, S=2 per
    device, 8 phases, byzantine-silence masks.  The run must decide."""
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.engine.epsfast import run_epsilon_fast
    from round_tpu_torch.models.epsilon import EpsilonConsensus

    devs = list(devices) if devices is not None else _visible_devices()
    devs = [torch.device(d) for d in devs]
    if len(devs) < n_devices:
        raise RuntimeError(f"dryrun wants {n_devices} devices, have "
                           f"{len(devs)}")
    n3, f3, S3, ph3 = 16, 2, 2 * n_devices, 8
    algo = EpsilonConsensus(n3, f=f3, epsilon=0.5)

    def one_eps(key):
        dev = shard_device()
        gen = torch.Generator(device=dev).manual_seed(
            (key[0] << 32) + key[1])
        io = {"initial_value": torch.rand((n3,), generator=gen,
                                          device=dev) * 100.0}
        res = run_epsilon_fast(algo, io, n3, key,
                               scenarios.byzantine_silence(n3, f3,
                                                           device=dev),
                               ph3, device=dev)
        return res.state.decided, res.decided_round, res.state.decision

    keys = torch.stack([torch.arange(S3), torch.full((S3,), 9)], dim=1)
    _run, sh, parity = sharded_keyed_parity(one_eps, keys, n_devices,
                                            devices=devs)
    _check(parity, "eps_fused sharded diverged from single-device")
    _check(bool(sh[0].any()), "eps_fused dryrun decided nothing")
    print("dryrun_multichip eps-fused ok: count-rank engine scenario-"
          f"sharded over {n_devices} devices, raw-bit parity vs "
          "single-device")


def dryrun_pbft_vc(n_devices: int, devices=None) -> None:
    """The dry run's PBFT view-change segment (round_tpu/parallel/mesh.py::
    _dryrun_cpu, the view-change family): the 6-round batched engine
    (engine.fast.run_pbft_vc_fast) scenario-sharded over an n_devices line
    mesh, bit for bit against the mesh's first device alone — per-lane
    views make the coordinator a per-receiver gather and the
    distributedState accumulators [S, n, n] planes, all of which must shard
    along the scenario axis.  n=16, S=2 per device, 12 rounds, the
    four-family mix with f=3 crashes from round 0.  The run must decide."""
    from round_tpu_torch.engine import fast
    from round_tpu_torch.models.pbft import PbftVcState

    devs = list(devices) if devices is not None else _visible_devices()
    devs = [torch.device(d) for d in devs]
    if len(devs) < n_devices:
        raise RuntimeError(f"dryrun wants {n_devices} devices, have "
                           f"{len(devs)}")
    dev0 = devs[0]
    n6, S6, r6 = 16, 2 * n_devices, 12
    x6 = (torch.arange(n6, dtype=torch.int32, device=dev0) * 7 + 3) % 100
    gen = torch.Generator(device=dev0).manual_seed(19)
    mix6 = fast.standard_mix(gen, S6, n6, p_drop=0.15, f=3, crash_round=0,
                             device=dev0)
    st6 = PbftVcState.fresh(x6, S6, n6)
    sp = P(SCENARIO_AXIS)
    line = Mesh.line(devs[:n_devices], SCENARIO_AXIS)
    got = shard_map(lambda st, mx: fast.run_pbft_vc_fast(st, mx, r6), line,
                    in_specs=(sp, sp), out_specs=(sp, sp, sp))(st6, mix6)
    ref = fast.run_pbft_vc_fast(st6, mix6, r6)
    _assert_tree_parity(got, ref, "scenario-sharded view-change engine "
                        "diverged from single-device")
    _check(bool(got[0].decided.any()), "view-change dryrun decided nothing")
    print("dryrun_multichip view-change family ok: 6-round byzantine engine "
          f"scenario-sharded over {n_devices} devices, n={n6} scenarios="
          f"{S6}, bit-parity vs single-device, decided_lanes="
          f"{int(got[0].decided.sum())}/{S6 * n6}")
