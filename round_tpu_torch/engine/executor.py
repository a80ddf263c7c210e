"""The round engine: lockstep execution of an Algorithm.

Port of round_tpu/engine/executor.py (the scenario engine with its value-
adversary hook, and the host runner's per-lane round functions; the
serving-lane half, ``LaneStep`` and its helpers, is not ported yet).  Execution shape:

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
from round_tpu_torch.core.rounds import FoldRound, RoundCtx
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
        """Per-lane uint32 rng words (int64) for round r: ``[n]`` for one
        key, ``[W, n]`` for a pair of ``[W]`` int64 salt tensors (a window
        of instances, runtime/instances.py), row w the words of key w."""
        from round_tpu_torch.engine.scenarios import _key_salt
        from round_tpu_torch.ops.fused import _GOLD, _RMIX, _fmix32

        if isinstance(key, tuple) and isinstance(key[0], torch.Tensor):
            k0, k1 = key[0][:, None], key[1][:, None]
        else:
            k0, k1 = _key_salt(key)
        lanes = self.lane_ids().to(torch.int64)
        z = (lanes * _GOLD + k0) & _M32
        z = z ^ ((int(r) * _RMIX + k1 + _UPD_STREAM) & _M32)
        return _fmix32(z)


def run_round(rnd, state, done, r: int, ho, key, topo, adversary=None,
              adv_class: int = 0, adv_prev=None, lane_words=None):
    """Execute one communication-closed round on this device's lane slice
    (round_tpu/engine/executor.py::run_round).

    ``lane_words`` (``[n_local]`` uint32 words in int64) stands in for
    ``topo.lane_keys(key, r)`` where the caller drew them already: a
    window of instances run under ``vmap`` draws its ``[W, n]`` words in
    one call outside it (runtime/instances.py).

    With an ``adversary`` (byz/adversary.py ValueAdversary) the mailbox
    values each receiver folds are per-receiver substitutions of the
    truthful payload (equivocation, stale replay), folded by the same
    vmapped update; ``adv_class`` is the static round-class index (the lie
    model's dispatch), ``adv_prev`` the class's stale carry, and the
    return is ``(state, done, new_prev)``.  ``adversary=None`` runs the
    round without any of it.  Value adversaries run on LocalTopology
    only."""
    n = topo.n
    ids = topo.lane_ids()
    # filled on the device: a host-to-device copy would wait for it
    r_t = torch.full((), r, dtype=torch.int32, device=ids.device)
    if lane_words is None:
        lane_words = topo.lane_keys(key, r)
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

    if adversary is not None:
        # the substitution tensor is [n_recv, n_send, ...]: sharded
        # receivers would need their slice of it
        if not isinstance(topo, LocalTopology):
            raise NotImplementedError(
                "value adversaries run on LocalTopology only")
        values, new_prev = adversary.apply(adv_class, r, payload, dest,
                                           adv_prev)

        def _update_adv(i, s, mbox_mask, k, vals):
            ctx = RoundCtx(id=i, n=n, r=r_t, rng=k)
            s2 = rnd.update(ctx, s, Mailbox(vals, mbox_mask))
            return s2, ctx._exit

        new_state, exit_flags = vmap(_update_adv)(
            ids, state, deliver, lane_words, values)
        state = tree_where(active_local, new_state, state)
        done = torch.logical_or(done,
                                torch.logical_and(active_local, exit_flags))
        return state, done, new_prev

    # update: per-lane fold of the mailbox into the state
    def _update(i, s, mbox_mask, k):
        ctx = RoundCtx(id=i, n=n, r=r_t, rng=k)
        s2 = rnd.update(ctx, s, Mailbox(payload, mbox_mask))
        return s2, ctx._exit

    new_state, exit_flags = vmap(_update)(
        ids, state, deliver, lane_words)

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


def adversary_prev0(algo: Algorithm, state0, topo, adversary) -> tuple:
    """The stale carry's start, one per round class: zeros shaped like the
    class's payload, from a send trace on ``state0`` (round_tpu/engine/
    executor.py::run_phases' ``_payload_zero``)."""
    ids = topo.lane_ids()

    def _payload_zero(j, rnd):
        r_j = torch.full((), j, dtype=torch.int32, device=ids.device)

        def _s(i, s):
            ctx = RoundCtx(id=i, n=topo.n, r=r_j)
            return rnd.send(ctx, rnd.pre(ctx, s)).payload

        return tree_map(torch.zeros_like, vmap(_s)(ids, state0))

    return tuple(adversary.init_prev(_payload_zero(j, rnd))
                 for j, rnd in enumerate(algo.rounds))


def run_phases(
    algo: Algorithm,
    state0: Any,
    key,
    ho_sampler: HoSampler,
    max_phases: int,
    topo,
    record_fn: Optional[Callable[[Any, torch.Tensor, int], Any]] = None,
    adversary=None,
):
    """Run `max_phases` phases over an initialized lane slice.  Returns
    (state, done, decided_round, recorded).

    With an ``adversary`` (byz/adversary.py ValueAdversary) every round's
    mailbox values pass through the value-substitution hook (run_round),
    and one (ever-sent, last-sent payload) stale carry per round class
    rides along (round_tpu/engine/executor.py::run_phases)."""
    k_rounds = algo.rounds_per_phase
    if k_rounds < 1:
        raise ValueError("algorithm has no rounds")
    n_local = topo.n_local
    dev = topo.device

    state = state0
    done = torch.zeros((n_local,), dtype=torch.bool, device=dev)
    decided_round = torch.full((n_local,), -1, dtype=torch.int32, device=dev)
    prev = (list(adversary_prev0(algo, state0, topo, adversary))
            if adversary is not None else None)
    recs = []
    for phase in range(max_phases):
        for j, rnd in enumerate(algo.rounds):
            r = phase * k_rounds + j
            ho = ho_sampler(key, r)
            if adversary is not None:
                state, done, prev[j] = run_round(
                    rnd, state, done, r, ho, key, topo, adversary=adversary,
                    adv_class=j, adv_prev=prev[j])
            else:
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


def host_lane_word(salts, r: int, sid: int) -> int:
    """The rng word ``LocalTopology.lane_keys(salts, r)[sid]``, computed
    on the host: a replica's draws are then the general engine's on the
    same key."""
    from round_tpu_torch.engine.scenarios import mix32_host
    from round_tpu_torch.ops.fused import _GOLD, _RMIX

    k0, k1 = salts
    z = (sid * _GOLD + k0) & _M32
    z ^= (int(r) * _RMIX + k1 + _UPD_STREAM) & _M32
    return mix32_host(z)


def make_host_round_fns(rnd, n: int, device=None):
    """The per-lane (send, update, go) functions of one Round at group
    size ``n`` for the host runner (round_tpu/engine/executor.py::
    make_host_round_fns).  They run one lane, unbatched, on ``device``
    (the card unless the caller passes another).

    Signatures (``rr``, ``sid`` Python ints, ``seed`` an int seed; state
    and vals pytrees of tensors on the device):
      f_send(rr, sid, seed, state)               -> (state', payload, dest)
      f_update(rr, sid, seed, state, vals, mask) -> (state', exit_flag)
      f_go(rr, sid, seed, state, vals, mask)     -> go   (FoldRound only,
                                                          else None)

    round_tpu gives every call the key ``fold_in(fold_in(PRNGKey(seed),
    rr), sid)``.  Here pre and send get no rng, as in ``run_round``, and
    update and the go probe get ``host_lane_word(host_key_salts(seed), rr,
    sid)``, the word the general engine gives lane ``sid`` at round ``rr``
    under ``host_key_salts(seed)``: a replica's draws equal the general
    engine's on that key.  Ids, rounds and words are 0-d tensors filled
    on the device (no host-to-device copy); ids and rounds are kept for
    reuse."""
    from round_tpu_torch.engine.scenarios import host_key_salts

    dev = resolve_device(device)
    consts: dict = {}

    def const(value: int, dtype):
        t = consts.get((value, dtype))
        if t is None:
            t = consts[(value, dtype)] = torch.full((), value, dtype=dtype,
                                                   device=dev)
        return t

    def mk_ctx(rr, sid, seed=None):
        rng = None
        if seed is not None:
            rng = torch.full((), host_lane_word(host_key_salts(seed), rr,
                                                sid),
                             dtype=torch.int64, device=dev)
        return RoundCtx(id=const(sid, torch.int32), n=n,
                        r=const(rr, torch.int32), rng=rng)

    def f_send(rr, sid, seed, state):
        ctx = mk_ctx(rr, sid)
        st = rnd.pre(ctx, state)
        spec = rnd.send(ctx, st)
        return st, spec.payload, spec.dest_mask

    def f_update(rr, sid, seed, state, vals, mask):
        ctx = mk_ctx(rr, sid, seed)
        st2 = rnd.update(ctx, state, Mailbox(vals, mask))
        return st2, ctx._exit

    f_go = None
    if isinstance(rnd, FoldRound):
        def f_go(rr, sid, seed, state, vals, mask):  # noqa: E306
            ctx = mk_ctx(rr, sid, seed)
            m, count = rnd.fold(ctx, state, Mailbox(vals, mask))
            return rnd.go_ahead(ctx, state, m, count)

    return f_send, f_update, f_go
