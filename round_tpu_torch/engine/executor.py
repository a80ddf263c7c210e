"""The round engine: lockstep execution of an Algorithm.

Port of round_tpu/engine/executor.py (the scenario engine with its value-
adversary hook, the host runner's per-lane round functions, and the
serving-lane half: ``LaneStep``, ``lane_step``, ``lane_sample_rows`` and
``lane_decide``).  Execution shape:

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
import threading
from typing import Any, Callable, Optional

import numpy as np
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


def lane_words(salt0, salt1, rr: torch.Tensor, sid: int) -> torch.Tensor:
    """``host_lane_word`` over tensors, on their device: the words of
    replica ``sid`` for per-lane salts ``salt0``/``salt1`` (ints or
    ``[L]`` int64 tensors) at per-lane rounds ``rr`` (``[L]`` int32),
    as ``[L]`` uint32 words held in int64.  Bit for bit the host
    function's, lane by lane (the lane driver's update and go probe draw
    from these)."""
    from round_tpu_torch.ops.fused import _GOLD, _RMIX, _fmix32

    z = (int(sid) * _GOLD + salt0) & _M32
    z = z ^ ((rr.to(torch.int64) * _RMIX + salt1 + _UPD_STREAM) & _M32)
    return _fmix32(z)


def make_lane_round_fns(rnd, n: int):
    """The per-lane (send, update, go) functions of one Round at group
    size ``n`` with the context built from tensors: the single source of
    truth of the host runner's trio (``make_host_round_fns``) and of the
    lane driver's mega-step (``LaneStep``), as round_tpu keeps one
    (round_tpu/engine/executor.py::make_host_round_fns).

    Signatures (``rr``, ``sid`` int32 tensors, ``word`` the int64 rng
    word; state and vals pytrees of tensors):
      t_send(rr, sid, state)                     -> (state', payload, dest)
      t_update(rr, sid, word, state, vals, mask) -> (state', exit_flag)
      t_go(rr, sid, word, state, vals, mask)     -> go   (FoldRound only,
                                                          else None)
    Pre and send get no rng, as in ``run_round``."""

    def t_send(rr, sid, state):
        ctx = RoundCtx(id=sid, n=n, r=rr)
        st = rnd.pre(ctx, state)
        spec = rnd.send(ctx, st)
        return st, spec.payload, spec.dest_mask

    def t_update(rr, sid, word, state, vals, mask):
        ctx = RoundCtx(id=sid, n=n, r=rr, rng=word)
        st2 = rnd.update(ctx, state, Mailbox(vals, mask))
        return st2, ctx._exit

    t_go = None
    if isinstance(rnd, FoldRound):
        def t_go(rr, sid, word, state, vals, mask):  # noqa: E306
            ctx = RoundCtx(id=sid, n=n, r=rr, rng=word)
            m, count = rnd.fold(ctx, state, Mailbox(vals, mask))
            return rnd.go_ahead(ctx, state, m, count)

    return t_send, t_update, t_go


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
    reuse.  The math is ``make_lane_round_fns``'s."""
    from round_tpu_torch.engine.scenarios import host_key_salts

    dev = resolve_device(device)
    consts: dict = {}
    t_send, t_update, t_go = make_lane_round_fns(rnd, n)

    def const(value: int, dtype):
        t = consts.get((value, dtype))
        if t is None:
            t = consts[(value, dtype)] = torch.full((), value, dtype=dtype,
                                                   device=dev)
        return t

    def word(rr, sid, seed):
        return torch.full((), host_lane_word(host_key_salts(seed), rr, sid),
                          dtype=torch.int64, device=dev)

    def f_send(rr, sid, seed, state):
        return t_send(const(rr, torch.int32), const(sid, torch.int32), state)

    def f_update(rr, sid, seed, state, vals, mask):
        return t_update(const(rr, torch.int32), const(sid, torch.int32),
                        word(rr, sid, seed), state, vals, mask)

    f_go = None
    if t_go is not None:
        def f_go(rr, sid, seed, state, vals, mask):  # noqa: E306
            return t_go(const(rr, torch.int32), const(sid, torch.int32),
                        word(rr, sid, seed), state, vals, mask)

    return f_send, f_update, f_go


# ---------------------------------------------------------------------------
# The lane half: many live instances of one replica as ONE vmapped lane axis
# ---------------------------------------------------------------------------

# serializes LaneStep and lane_decide builds: thread-mode replicas share
# Round objects and reach a round class within milliseconds of each other
_LANE_BUILD_LOCK = threading.Lock()


class LaneStep:
    """One Round's lane-axis mega-step at (n, lanes)
    (round_tpu/engine/executor.py::LaneStep): ``torch.func.vmap`` of
    ``make_lane_round_fns`` over a ``[L, ...]`` state pytree with a
    ragged lane mask.  Launches do not grow with L.

    Arguments, all on the state's device: ``rr`` ``[L]`` int32 per-lane
    rounds, ``seeds`` ``[L]`` int64 per-lane salts (lane l's seed s_l
    gives ``host_key_salts(s_l)[1]``; its salt0 is 0), ``active`` ``[L]``
    bool; ``sid`` is this replica's id (an int, shared by every lane).
    Lane l draws ``host_lane_word(host_key_salts(s_l), rr[l], sid)``,
    computed on the device by ``lane_words``: the word the host runner
    gives the same instance.  Inactive lanes keep their state bit for bit
    (``tree_where``), and their ``dest`` and exit flags are masked off.

      send(rr, sid, seeds, state, active)              -> (state', payload,
                                                           dest)
      update(rr, sid, seeds, state, vals, mask, active) -> (state', exit)
      go(rr, sid, seeds, state, vals, mask)             -> go  (FoldRound)

    ``vals``/``mask`` are the ``[L, n, ...]`` / ``[L, n]`` mailbox.

    With a ``monitor`` (rv/compile.py MonitorProgram) the update also
    reads every lane's post-update decision plane inside its vmap and
    evaluates the monitor verdicts on it, given the carried monitor
    state:

      update(..., active, prev_dec, prev_val, ext_dec, ext_val, init_vals)
          -> (state', exit, ok[L, F], decided[L], decision[L, ...])

    Inactive lanes are vacuously ok; the caller carries the plane
    forward for the active lanes only (round_tpu's update returns it
    already merged).  The update math is unchanged, so decision logs are
    the same with monitors on and off."""

    __slots__ = ("rnd", "n", "lanes", "monitor", "send", "update", "go",
                 "_ids")

    def __init__(self, rnd, n: int, lanes: int, monitor=None):
        self.rnd, self.n, self.lanes = rnd, n, lanes
        self.monitor = monitor
        t_send, t_update, t_go = make_lane_round_fns(rnd, n)
        self._ids: dict = {}
        ids = self._id
        v_send = vmap(t_send, in_dims=(0, None, 0))
        v_update = vmap(t_update, in_dims=(0, None, 0, 0, 0, 0))

        def send(rr, sid, seeds, state, active):
            st, payload, dest = v_send(rr, ids(sid, rr.device), state)
            return (tree_where(active, st, state), payload,
                    dest & active[:, None])

        def update(rr, sid, seeds, state, vals, mask, active):
            st2, ex = v_update(rr, ids(sid, rr.device),
                               lane_words(0, seeds, rr, sid), state, vals,
                               mask)
            return tree_where(active, st2, state), ex & active

        if monitor is not None:
            decided_fn, decision_fn = monitor.algo.decided, \
                monitor.algo.decision
            verdicts = monitor.verdicts

            def t_update_plane(rr, sid, word, state, vals, mask):
                st2, ex = t_update(rr, sid, word, state, vals, mask)
                return (st2, ex, decided_fn(st2).reshape(()),
                        decision_fn(st2))

            # the decision plane read inside the update's own vmap; the
            # verdicts over all lanes at once, in the same mega-step
            v_update_plane = vmap(t_update_plane,
                                  in_dims=(0, None, 0, 0, 0, 0))

            def update(rr, sid, seeds, state, vals, mask, active,  # noqa: F811
                       prev_dec, prev_val, ext_dec, ext_val, init_vals):
                st2, ex, dec, val = v_update_plane(
                    rr, ids(sid, rr.device), lane_words(0, seeds, rr, sid),
                    state, vals, mask)
                ok = verdicts(dec, val, prev_dec, prev_val, ext_dec,
                              ext_val, init_vals, active=active)
                return tree_where(active, st2, state), ex & active, ok, \
                    dec, val

        self.send, self.update, self.go = send, update, None
        if t_go is not None:
            v_go = vmap(t_go, in_dims=(0, None, 0, 0, 0, 0))

            def go(rr, sid, seeds, state, vals, mask):
                return v_go(rr, ids(sid, rr.device),
                            lane_words(0, seeds, rr, sid), state, vals, mask)

            self.go = go

    def _id(self, sid: int, device) -> torch.Tensor:
        """This replica's id as a 0-d int32 tensor filled on ``device``
        (no host-to-device copy), kept for reuse."""
        key = (int(sid), device)
        t = self._ids.get(key)
        if t is None:
            t = self._ids[key] = torch.full((), int(sid), dtype=torch.int32,
                                            device=device)
        return t


def lane_step(rnd, n: int, lanes: int, monitor=None) -> LaneStep:
    """The LaneStep of ``rnd`` at (n, lanes), with the ``monitor`` term
    fused into its update when given, cached on the round object under a
    lock (round_tpu/engine/executor.py::lane_step); monitored and plain
    steps cache apart.  There is no compile step and no warm-up call: the
    first dispatch runs eagerly."""
    key = (n, lanes, monitor is not None)
    cache = getattr(rnd, "_lane_steps", None)
    if cache is not None and key in cache:
        return cache[key]
    with _LANE_BUILD_LOCK:
        cache = getattr(rnd, "_lane_steps", None)
        if cache is None:
            cache = rnd._lane_steps = {}
        if key not in cache:
            cache[key] = LaneStep(rnd, n, lanes, monitor=monitor)
        return cache[key]


def lane_sample_rows(leaves, lane: int):
    """One lane's rows of the ``[L, ...]`` state leaves as owning host
    arrays, shapes kept (a 0-d row stays 0-d), in ONE device-to-host copy
    (round_tpu/engine/executor.py::lane_sample_rows, where the rows are
    already on the host)."""
    from round_tpu_torch.runtime.host import to_numpy

    return [np.array(row) for row in to_numpy([leaf[lane] for leaf in leaves])]


def lane_decide(algo: Algorithm, lanes: int):
    """``state[L, ...] -> (decided[L], decision[L, ...])`` under vmap,
    cached on the algorithm per lane width
    (round_tpu/engine/executor.py::lane_decide): the lane driver's
    retire path, one dispatch per update wave that had exits."""
    cache = getattr(algo, "_lane_decide", None)
    if cache is not None and lanes in cache:
        return cache[lanes]
    with _LANE_BUILD_LOCK:
        cache = getattr(algo, "_lane_decide", None)
        if cache is None:
            cache = algo._lane_decide = {}
        if lanes not in cache:
            cache[lanes] = vmap(
                lambda s: (algo.decided(s), algo.decision(s)))
        return cache[lanes]
