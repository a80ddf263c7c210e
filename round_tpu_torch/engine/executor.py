"""The round engine: lockstep execution of an Algorithm.

Port of round_tpu/engine/executor.py (the scenario engine; the adversary
hook and the serving-lane half are later slices).  Execution shape:

  - per-lane user functions are batched over the process axis with
    ``torch.func.vmap`` (``ctx`` is built inside the vmapped function),
  - one round = send -> exchange -> update,
  - a phase = the algorithm's round tuple,
  - the run = a Python loop over phases (``done`` lanes freeze),
  - scenarios = a Python loop over ``run_instance`` (``simulate``).

Keys: a key is a pair of uint32 salts ``(salt0, salt1)``.  Samplers receive
the key unchanged every round, so scenario-constant fault sets stay
constant; the per-lane ``ctx.rng`` word is a hash of (key, round, lane)
on a stream of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import vmap

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import RoundCtx
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import (
    tree_leaves, tree_map, tree_stack, tree_where,
)

HoSampler = Callable[[Any, int], torch.Tensor]  # (key, r) -> [n, n] bool

_M32 = 0xFFFFFFFF
_UPD_STREAM = 0x3C6EF372  # separates the lane-rng stream from the HO stream


class LocalTopology:
    """All n lanes live on this device; gathers are identity."""

    def __init__(self, n: int, device=None):
        self.n = n
        self.n_local = n
        self.device = resolve_device(device)

    def lane_ids(self) -> torch.Tensor:
        return torch.arange(self.n, dtype=torch.int32, device=self.device)

    def gather(self, tree: Any) -> Any:
        """Make per-lane outputs visible to every receiver (identity here)."""
        return tree

    def ho_rows(self, ho: torch.Tensor) -> torch.Tensor:
        """This device's receiver rows of the full [n, n] HO matrix."""
        return ho

    def dest_cols(self, dest: torch.Tensor) -> torch.Tensor:
        """[n_local, n]: dest_mask[i, j] transposed to local receiver rows."""
        return dest.T

    def lane_keys(self, key, r: int) -> torch.Tensor:
        """Per-lane uint32 rng words (int64) for round r."""
        from round_tpu_torch.engine.scenarios import _key_salt
        from round_tpu_torch.ops.fused import _GOLD, _RMIX, _fmix32

        k0, k1 = _key_salt(key)
        lanes = self.lane_ids().to(torch.int64)
        z = (lanes * _GOLD + k0) & _M32
        z = z ^ ((int(r) * _RMIX + k1 + _UPD_STREAM) & _M32)
        return _fmix32(z)


def run_round(rnd, state, done, r: int, ho, key, topo):
    """Execute one communication-closed round on this device's lane slice
    (round_tpu/engine/executor.py::run_round without the adversary hook)."""
    n = topo.n
    ids = topo.lane_ids()
    r_t = torch.tensor(r, dtype=torch.int32, device=ids.device)
    active_local = torch.logical_not(done)

    # pre (EventRound init slot): runs before send, visible to send+update
    def _pre(i, s):
        return rnd.pre(RoundCtx(id=i, n=n, r=r_t), s)

    state = tree_where(active_local, vmap(_pre)(ids, state), state)

    # send: per-lane -> payload [n_local, ...], dest_mask [n_local, n]
    def _send(i, s):
        spec = rnd.send(RoundCtx(id=i, n=n, r=r_t), s)
        return spec.payload, spec.dest_mask

    payload_loc, dest_loc = vmap(_send)(ids, state)

    # the wire: make all senders visible, then one masked transpose
    payload = topo.gather(payload_loc)
    dest = topo.gather(dest_loc)
    active = topo.gather(active_local)
    deliver = topo.ho_rows(ho) & topo.dest_cols(dest) & active[None, :]

    # update: per-lane fold of the mailbox into the state
    def _update(i, s, mbox_mask, k):
        ctx = RoundCtx(id=i, n=n, r=r_t, rng=k)
        s2 = rnd.update(ctx, s, Mailbox(payload, mbox_mask))
        return s2, ctx._exit

    new_state, exit_flags = vmap(_update)(
        ids, state, deliver, topo.lane_keys(key, r))

    # frozen lanes keep their state; exits only count for active lanes
    state = tree_where(active_local, new_state, state)
    done = torch.logical_or(done, torch.logical_and(active_local, exit_flags))
    return state, done


def _decided_or_false(algo: Algorithm, state, n_local: int, device):
    try:
        return algo.decided(state)
    except NotImplementedError:
        return torch.zeros((n_local,), dtype=torch.bool, device=device)


def init_lanes(algo: Algorithm, io: Any, n: int, topo) -> Any:
    """vmap the per-lane init over this device's lane slice of the io pytree."""
    r0 = torch.tensor(0, dtype=torch.int32, device=topo.device)
    io = tree_map(lambda leaf: torch.as_tensor(leaf, device=topo.device), io)

    def _init(i, io_lane):
        return algo.make_init_state(RoundCtx(id=i, n=n, r=r0), io_lane)

    return vmap(_init)(topo.lane_ids(), io)


def run_phases(
    algo: Algorithm,
    state0: Any,
    key,
    ho_sampler: HoSampler,
    max_phases: int,
    topo,
    record_fn: Optional[Callable[[Any, torch.Tensor, int], Any]] = None,
):
    """Run `max_phases` phases over an initialized lane slice.  Returns
    (state, done, decided_round, recorded)."""
    k_rounds = algo.rounds_per_phase
    if k_rounds < 1:
        raise ValueError("algorithm has no rounds")
    n_local = topo.n_local
    dev = topo.device

    state = state0
    done = torch.zeros((n_local,), dtype=torch.bool, device=dev)
    decided_round = torch.full((n_local,), -1, dtype=torch.int32, device=dev)
    recs = []
    for phase in range(max_phases):
        for j, rnd in enumerate(algo.rounds):
            r = phase * k_rounds + j
            ho = ho_sampler(key, r)
            state, done = run_round(rnd, state, done, r, ho, key, topo)
            dec = _decided_or_false(algo, state, n_local, dev)
            decided_round = torch.where(dec & (decided_round < 0), r,
                                        decided_round)
            if record_fn is not None:
                recs.append(record_fn(state, done, r))
    recorded = tree_stack(recs) if recs else None
    return state, done, decided_round, recorded


@dataclasses.dataclass
class RunResult:
    """Outcome of one (or a batch of) simulated instance(s).

    state:         final state pytree ([n, ...] per leaf; [S, n, ...] batched)
    done:          [n] bool — lanes that exited (exitAtEndOfRound)
    decided_round: [n] int32 — first round where `algo.decided` flipped, else -1
    rounds_run:    total rounds executed
    recorded:      stacked per-round outputs of record_fn, if any ([T, ...])
    """

    state: Any
    done: torch.Tensor
    decided_round: torch.Tensor
    rounds_run: int
    recorded: Any = None


def run_instance(
    algo: Algorithm,
    io: Any,
    n: int,
    key,
    ho_sampler: HoSampler,
    max_phases: int,
    record_fn: Optional[Callable[[Any, torch.Tensor, int], Any]] = None,
    device=None,
) -> RunResult:
    """Run one instance (one fault scenario) for `max_phases` phases.

    key: a ``(salt0, salt1)`` pair; ho_sampler: (key, r) -> [n, n] bool HO
    mask for round r, on ``device``."""
    topo = LocalTopology(n, device)
    state0 = init_lanes(algo, io, n, topo)
    state, done, decided_round, recorded = run_phases(
        algo, state0, key, ho_sampler, max_phases, topo, record_fn
    )
    return RunResult(
        state=state,
        done=done,
        decided_round=decided_round,
        rounds_run=max_phases * algo.rounds_per_phase,
        recorded=recorded,
    )


def simulate(
    algo: Algorithm,
    io: Any,
    n: int,
    key,
    ho_sampler: HoSampler,
    max_phases: int,
    n_scenarios: int = 1,
    record_fn=None,
    io_batched: Optional[bool] = None,
    device=None,
) -> RunResult:
    """Run `n_scenarios` independent fault scenarios and stack the results.

    Scenario s gets the key ``(mix32(salt0 + s·GOLD), salt1)``.  `io` leaves
    may be [n, ...] (shared across scenarios) or [S, n, ...] (per-scenario;
    pass io_batched=True to disambiguate when S == n)."""
    from round_tpu_torch.engine.scenarios import _key_salt, mix32_host
    from round_tpu_torch.ops.fused import _GOLD

    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(io)]
    if io_batched is None:
        looks_shared = all(leaf.dim() >= 1 and leaf.shape[0] == n
                           for leaf in leaves)
        looks_batched = all(leaf.dim() >= 2 and leaf.shape[0] == n_scenarios
                            and leaf.shape[1] == n for leaf in leaves)
        if looks_shared == looks_batched:
            raise ValueError(
                "cannot tell whether io is per-scenario [S, n, ...] or shared "
                f"[n, ...] (n={n}, n_scenarios={n_scenarios}, leaf shapes="
                f"{[tuple(leaf.shape) for leaf in leaves]}); pass io_batched "
                "explicitly")
        io_batched = looks_batched
    k0, k1 = _key_salt(key)
    results = []
    for s in range(n_scenarios):
        io_s = tree_map(lambda leaf: leaf[s], io) if io_batched else io
        key_s = (mix32_host(k0 + s * _GOLD), k1)
        results.append(run_instance(algo, io_s, n, key_s, ho_sampler,
                                    max_phases, record_fn, device))
    first = results[0]
    return RunResult(
        state=tree_stack([res.state for res in results]),
        done=torch.stack([res.done for res in results]),
        decided_round=torch.stack([res.decided_round for res in results]),
        rounds_run=first.rounds_run,
        recorded=(tree_stack([res.recorded for res in results])
                  if first.recorded is not None else None),
    )
