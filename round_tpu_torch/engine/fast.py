"""The fused fast engine: histogram rounds through the CUDA exchange kernel.

Port of round_tpu/engine/fast.py, whole.  For *histogram rounds* —
broadcast a small-domain value, consume the mailbox only through per-value
counts (OTR, FloodMin, Ben-Or, early-stopping k-set agreement, and with
guarded sends Two-Phase Commit and eager reliable broadcast) — the whole
round runs through ``ops.fused.hist_exchange`` (K2, one launch per round:
``run_hist``, ``run_tpc_fast``, ``run_erb_fast``) or the whole run through
one K1 launch (``ops.fused.hist_loop``: ``run_otr_loop``, the flagship
path, ``run_floodmin_loop`` and ``run_benor_loop``).  The [S, n, n] mask
never exists in device memory on those paths.

The matrix-state and guarded-send engines — lattice agreement
(``run_lattice_fast``), ◇S (``run_esfd_fast``), Θ (``run_theta_fast``),
PBFT with and without view change (``run_pbft_fast``,
``run_pbft_vc_fast``), the token ring (``run_mutex_fast``) and Game of
Life (``run_gol_fast``) — ride the same ``hist_scan`` scaffolding over the
dense hash-mode mask (``mix_ho``): bit-plane products as float32 ``bmm`` of
0/1 operands (exact counts), masked row sums and gathers, as round_tpu
computes them outside any Pallas kernel.  ``mix_ho_stats`` and
``sampler_ho_stats`` aggregate those masks per round.  ``run_hist`` and
``run_otr_loop`` count ``engine.hist_runs`` and ``engine.loop_runs`` in
``obs.metrics.METRICS``.

The fault model is a `FaultMix`: per-scenario structured parameters (crash
sets, partition sides, a rotating suppressed process, an iid-omission
threshold, hash salts) from which each round's O(S·n) kernel inputs are
derived.  The same parameters replay exactly in the general engine through
``scenarios.from_fault_params`` (hash mode).

Every runner takes ``mode``: "hw" (the default, as in round_tpu) draws the
links from the hw-mode Philox stream of ``ops.fused``, "hash" from the
hash that the general engine replays.  A caller that needs round_tpu's
bits, or a replay in the general engine, passes ``mode="hash"``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.ops import fused
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import struct, tree_where

_RMIX = 0x7FEB352D


@struct
class FaultMix:
    """Per-scenario fault parameters (all leaves have leading axis [S]).

      crashed:      [S, n] bool — processes that crash at `crash_round`
      crash_round:  [S] int32
      side:         [S, n] int32 — partition side id until `heal_round`
      heal_round:   [S] int32
      rotate_down:  [S] int32 — 0 = off; k = process (r // k) % n is
                    suppressed each round
      p8:           [S] int32 — iid per-link drop threshold (p = p8/256)
      salt0/salt1:  [S] int32 — hash-sampler salts (uint32 bit patterns)

    The value-adversary fields (optional, None by default; no fast engine
    reads them, the general engine's adversary hook does —
    byz/adversary.py, fuzz/search.py):

      byz_value:    [S, n] bool — senders that lie
      equiv_p8:     [S] int32 — per-(round, src, dst) substitution
                    threshold (p = equiv_p8/256) under STREAM_BYZ_VAL
      stale_p8:     [S] int32 — stale-replay threshold under
                    STREAM_BYZ_STALE
    """

    crashed: torch.Tensor
    crash_round: torch.Tensor
    side: torch.Tensor
    heal_round: torch.Tensor
    rotate_down: torch.Tensor
    p8: torch.Tensor
    salt0: torch.Tensor
    salt1: torch.Tensor
    byz_value: Optional[torch.Tensor] = None
    equiv_p8: Optional[torch.Tensor] = None
    stale_p8: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.crashed.shape[-1]


def _salts(gen: torch.Generator, S: int, which: int, device=None) -> torch.Tensor:
    """S uniform uint32 salts as int32 bit patterns, drawn from `gen`.
    `which` (0 or 1) names the salt for parity with round_tpu; the two
    salts are successive draws of the generator."""
    dev = resolve_device(device)
    bits = torch.randint(0, 2**32, (S,), generator=gen, dtype=torch.int64,
                         device=dev)
    return fused._i32(bits)


def fault_free(gen: torch.Generator, S: int, n: int, device=None) -> FaultMix:
    dev = resolve_device(device)
    z = torch.zeros((S,), dtype=torch.int32, device=dev)
    return FaultMix(
        crashed=torch.zeros((S, n), dtype=torch.bool, device=dev),
        crash_round=z,
        side=torch.zeros((S, n), dtype=torch.int32, device=dev),
        heal_round=z,
        rotate_down=z,
        p8=z,
        salt0=_salts(gen, S, 0, dev),
        salt1=_salts(gen, S, 1, dev),
    )


def standard_mix(
    gen: torch.Generator,
    S: int,
    n: int,
    p_drop: float = 0.25,
    f: Optional[int] = None,
    crash_round: int = 0,
    heal_round: int = 5,
    rotate_period: int = 1,
    device=None,
) -> FaultMix:
    """The flagship workload: scenarios split evenly across four families
    (round_tpu/engine/fast.py::standard_mix):

      0: iid omission at p_drop,
      1: f processes crash at `crash_round` (+ light omission),
      2: two-way partition until `heal_round`,
      3: rotating suppressed process (+ light omission).

    Drawn from the torch.Generator `gen`, which must live on `device`, so
    the draws differ from round_tpu's threefry draws; the structure is the
    same."""
    dev = resolve_device(device)
    if f is None:
        f = max(1, n // 4)
    fam = torch.arange(S, dtype=torch.int32, device=dev) % 4

    # a uniform permutation per scenario: crashed = perm < f, exactly f
    perm = torch.argsort(
        torch.rand((S, n), generator=gen, device=dev), dim=1)
    crashed = perm < f
    side = (torch.rand((S, n), generator=gen, device=dev) < 0.5).to(
        torch.int32)

    p8_full = max(1, round(p_drop * 256))
    p8_light = max(1, round(p_drop * 64))

    def per_family(values) -> torch.Tensor:
        table = torch.tensor(values, dtype=torch.int32, device=dev)
        return table[fam.long()]

    return FaultMix(
        crashed=crashed & (fam == 1)[:, None],
        crash_round=torch.full((S,), crash_round, dtype=torch.int32,
                               device=dev),
        side=side * (fam == 2)[:, None].to(torch.int32),
        heal_round=per_family([0, 0, heal_round, 0]),
        rotate_down=per_family([0, 0, 0, rotate_period]),
        p8=per_family([p8_full, p8_light, 0, p8_light]),
        salt0=_salts(gen, S, 0, dev),
        salt1=_salts(gen, S, 1, dev),
    )


def round_params(mix: FaultMix, r: int) -> Tuple[torch.Tensor, ...]:
    """Derive round-r kernel inputs [S, n] from the mix (O(S·n) work)."""
    S, n = mix.crashed.shape
    alive = ~(mix.crashed & (r >= mix.crash_round)[:, None])
    period = torch.clamp(mix.rotate_down, min=1)
    victim = (r // period) % n
    lane = torch.arange(n, device=mix.crashed.device)
    rotated = (lane[None, :] == victim[:, None]) & (mix.rotate_down > 0)[:, None]
    colmask = alive & ~rotated
    side_r = torch.where((r < mix.heal_round)[:, None], mix.side, 0)
    # int32 wrap == uint32 wrap
    salt1r = fused._i32(r * _RMIX + fused._u32(mix.salt1))
    return colmask, side_r, mix.p8, mix.salt0, salt1r


class HistRound:
    """A round whose update consumes only the value histogram; its
    `update_counts` is batched over [S, n] (round_tpu/engine/fast.py::
    HistRound).  ``phase_len > 1`` selects the subround ``k = r % phase_len``;
    ``needs_coin`` asks for the [S, n] hash-coin matrix each round;
    ``needs_lane_ids`` passes the global ids of the local lanes to
    ``update_counts`` as ``lane_ids=``; ``no_exchange_subrounds`` names the
    subrounds that consume no counts, whose exchange the engines skip."""

    num_values: int
    phase_len: int = 1
    needs_coin: bool = False
    needs_lane_ids: bool = False
    no_exchange_subrounds: Tuple[int, ...] = ()

    def payload(self, state, k: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        """counts [S, V, n] int32, size [S, n] int32 → (state, exit [S, n])."""
        raise NotImplementedError


class OtrHist(HistRound):
    """OTR's round on the fused path — same math as models.otr.OtrRound
    with the n_values histogram."""

    def __init__(self, n_values: int, after_decision: int = 2):
        self.num_values = n_values
        self.after_decision = after_decision

    def payload(self, state, k: int = 0):
        return state.x

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        quorum = size > (2 * n) // 3
        v_count = counts.max(dim=1).values
        rows = torch.arange(self.num_values, dtype=state.x.dtype,
                            device=counts.device)[None, :, None]
        # first maximum = the smallest most-often-received value, written
        # out rather than left to argmax's tie behaviour
        v = torch.where(counts == v_count[:, None, :], rows,
                        self.num_values).min(dim=1).values.to(state.x.dtype)
        super_quorum = quorum & (v_count > (2 * n) // 3)
        state = ghost_decide(state, super_quorum, v)
        after = torch.where(state.decided, state.after - 1, state.after)
        exit_ = state.decided & (after <= 0)
        state = state.replace(x=torch.where(quorum, v, state.x), after=after)
        return state, exit_


class FloodMinHist(HistRound):
    """FloodMin on the fused path (FloodMin.scala:22-33;
    round_tpu/engine/fast.py::FloodMinHist): x folds to the min over
    delivered values, decide after round f.  The min over the mailbox is
    min{v : counts[v] > 0} — straight off the histogram."""

    def __init__(self, n_values: int, f: int):
        self.num_values = n_values
        self.f = f

    def payload(self, state, k: int = 0):
        return state.x

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        V = self.num_values
        rows = torch.arange(V, dtype=torch.int32,
                            device=counts.device)[None, :, None]
        xm = torch.where(counts > 0, rows, V).min(dim=1).values.to(
            state.x.dtype)
        x = torch.minimum(state.x, xm)  # self-delivery already includes own x
        deciding = torch.full(x.shape, r > self.f, dtype=torch.bool,
                              device=x.device)
        state = ghost_decide(state.replace(x=x), deciding, x)
        return state, deciding


class BenOrHist(HistRound):
    """Ben-Or on the fused path (BenOr.scala:11-88;
    round_tpu/engine/fast.py::BenOrHist): two subrounds per phase over one
    4-value histogram domain.

    Subround 0 broadcasts (x, canDecide) as v = x + 2·can; subround 1
    broadcasts the vote as v = vote + 1 (3 live values).  The coin is the
    deterministic hash coin (ops.fused.hash_coin), replayable in the
    general engine via BenOr(coin_salt=...)."""

    num_values = 4
    phase_len = 2
    needs_coin = True

    def payload(self, state, k: int = 0):
        if k == 0:
            return state.x.to(torch.int32) + 2 * state.can_decide.to(
                torch.int32)
        return state.vote + 1

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        half = n // 2
        if k == 0:
            t_cnt = counts[:, 1] + counts[:, 3]
            f_cnt = counts[:, 0] + counts[:, 2]
            t_dec = counts[:, 3] > 0
            f_dec = counts[:, 2] > 0
            vote_new = torch.where(
                (t_cnt > half) | t_dec, 1,
                torch.where((f_cnt > half) | f_dec, 0, -1)).to(torch.int32)
            can_any = (counts[:, 2] + counts[:, 3]) > 0

            deciding = state.can_decide
            state = ghost_decide(state, deciding, state.x)
            state = state.replace(
                vote=torch.where(deciding, state.vote, vote_new),
                can_decide=torch.where(deciding, state.can_decide, can_any),
            )
            return state, deciding
        t = counts[:, 2]
        f = counts[:, 1]
        x2 = torch.where(
            t > half, True,
            torch.where(f > half, False,
                        torch.where(t > 1, True,
                                    torch.where(f > 1, False, coin))))
        can2 = (t > half) | (f > half) | state.can_decide
        frozen = state.decided
        state = state.replace(
            x=torch.where(frozen, state.x, x2),
            can_decide=torch.where(frozen, state.can_decide, can2),
        )
        return state, torch.zeros_like(frozen)


def subtract_self_delivery(counts, payload, excl, num_values: int):
    """The exchange kernel hard-wires broadcast self-delivery (the eye term
    of the HO formula) even through colmask; a GUARDED send must not
    self-deliver on excluded lanes — subtract the own-payload count where
    `excl` marks an active lane the guard excludes.  Shared by every
    guarded-send fused path (TPC's commit round, ERB's flooding;
    round_tpu/engine/fast.py::subtract_self_delivery)."""
    onehot_own = (
        payload[:, None, :]
        == torch.arange(num_values, dtype=payload.dtype,
                        device=payload.device)[None, :, None]
    ) & excl[:, None, :]
    return counts - onehot_own.to(torch.int32)


class TpcHist(HistRound):
    """Two-Phase Commit on the fused path (models/tpc.py semantics,
    TwoPhaseCommit.scala:16-81; round_tpu/engine/fast.py::TpcHist): one
    3-subround phase over a V=2 histogram.  The guarded sends become
    per-subround column masks (prepare/commit: only the coordinator's
    column transmits); the vote round's coordinator-only delivery needs no
    row mask — non-coordinator receivers compute a discarded value, exactly
    as their general-engine mailboxes are empty.

      k=0 prepare: no state change.
      k=1 vote:    coord decides commit iff all n votes heard and yes
                   (size == n and yes-count == size).
      k=2 commit:  receivers adopt the (present) decision and decide;
                   an empty mailbox decides None = -1 (coord suspected)."""

    num_values = 2
    phase_len = 3
    needs_lane_ids = True  # the coordinator test is a lane-identity compare
    no_exchange_subrounds = (0,)  # prepare consumes nothing

    def payload(self, state, k: int = 0):
        from round_tpu_torch.models.tpc import DEC_COMMIT

        if k == 1:
            return state.vote.to(torch.int32)
        if k == 2:
            return (state.decision == DEC_COMMIT).to(torch.int32)
        return torch.zeros_like(state.decision)

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None,
                      lane_ids=None):
        from round_tpu_torch.models.tpc import DEC_ABORT, DEC_COMMIT

        no_exit = torch.zeros_like(size, dtype=torch.bool)
        if k == 0:
            return state, no_exit
        if k == 1:
            is_coord = lane_ids.to(state.coord.dtype)[None, :] == state.coord
            yes = counts[:, 1, :]
            all_yes = (size == n) & (yes == size)
            dec = torch.where(all_yes, DEC_COMMIT, DEC_ABORT).to(torch.int32)
            return state.replace(
                decision=torch.where(is_coord, dec, state.decision)
            ), no_exit
        got = size > 0
        v = torch.where(counts[:, 1, :] > 0, DEC_COMMIT, DEC_ABORT).to(
            torch.int32)
        state = state.replace(
            decision=torch.where(got, v, state.decision),
            decided=torch.ones_like(state.decided),
        )
        return state, ~no_exit


def run_tpc_fast(state0, mix: FaultMix, max_rounds: int = 3,
                 mode: str = "hash"):
    """TPC through the fused exchange (round_tpu/engine/fast.py::
    run_tpc_fast): hist_scan with a per-subround column mask (the
    coordinator's guarded broadcasts), one K2 launch per vote and commit
    round.  Lane-exact against the general engine on mixed-fault mixes,
    including the coordinator-crash suspect path (decision None = -1).
    The coordinator is uniform per scenario (column 0 of ``coord``)."""
    S, n = mix.crashed.shape
    rnd = TpcHist()
    coord_col = state0.coord[:, :1]                        # [S, 1] uniform
    is_coord_col = torch.arange(
        n, dtype=coord_col.dtype, device=coord_col.device)[None, :] == coord_col

    def counts_fn(state, k, done, r):
        if k in rnd.no_exchange_subrounds:
            # prepare consumes nothing (TwoPhaseCommit.scala:42-44): skip
            # the exchange kernel entirely
            return torch.zeros((S, rnd.num_values, n), dtype=torch.int32,
                               device=done.device)
        colmask, side_r, p8, salt0, salt1r = round_params(mix, r)
        if k == 2:
            # guarded broadcast: only the coordinator's column sends
            colmask = colmask & is_coord_col
        payload = rnd.payload(state, k)
        counts = fused.hist_exchange(
            payload, ~done, colmask, None, side_r, salt0, salt1r, p8,
            rnd.num_values, mode=mode,
        ).to(torch.int32)
        if k == 2:
            # without the subtraction a non-coordinator receiver with an
            # otherwise-empty mailbox would hear itself and miss the
            # coordinator-suspect path (decision None)
            counts = subtract_self_delivery(
                counts, payload, (~done) & ~is_coord_col, rnd.num_values)
        return counts

    return hist_scan(rnd, state0, lambda s: s.decided, max_rounds, n,
                     counts_fn)


class ErbHist(HistRound):
    """Eager reliable broadcast on the fused path (models/erb.py semantics,
    EagerReliableBroadcast.scala:13-47; round_tpu/engine/fast.py::ErbHist):
    the defined-senders flooding as a guarded histogram exchange.

    Adoption decodes as min{v : counts[v] > 0}.  The general engine adopts
    the LOWEST-ID heard sender's value (Mailbox.any_value); the two
    coincide exactly on ERB's protocol class — every defined sender of one
    instance carries the ORIGINATOR's value (the flooding invariant) —
    which is why the differential parity is lane-exact on
    protocol-generated runs.

    CONTRACT (do NOT reuse outside the flooding-invariant class): any round
    family where concurrently-defined senders may broadcast DIFFERENT
    values in the same exchange would make min-of-heard and
    lowest-sender-id adoption diverge silently.  Multi-writer broadcast
    needs its own HistRound with an explicit tie-break matching the general
    engine, not this class."""

    def __init__(self, n_values: int):
        from round_tpu_torch.models.erb import GIVE_UP_ROUND

        self.num_values = n_values
        self.give_up_round = GIVE_UP_ROUND  # the model's constant: one source

    def payload(self, state, k: int = 0):
        return state.x_val

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        V = self.num_values
        got_any = size > 0
        rows = torch.arange(V, dtype=torch.int32,
                            device=counts.device)[None, :, None]
        adopted = torch.where(counts > 0, rows, V).min(dim=1).values.to(
            state.x_val.dtype)
        delivering = state.x_def
        give_up = ~state.x_def & ~got_any & (r > self.give_up_round)
        newly = delivering & ~state.delivered
        state = state.replace(
            x_val=torch.where(~state.x_def & got_any, adopted, state.x_val),
            x_def=state.x_def | got_any,
            delivered=state.delivered | delivering,
            delivery=torch.where(newly, state.x_val, state.delivery),
        )
        return state, delivering | give_up


def run_erb_fast(state0, mix: FaultMix, max_rounds: int, n_values: int,
                 mode: str = "hash"):
    """ERB through the fused exchange (round_tpu/engine/fast.py::
    run_erb_fast): the send guard (only DEFINED lanes broadcast,
    models/erb.py ErbRound.send) becomes a state-dependent column mask,
    with the kernel's hard-wired self-delivery subtracted on guard-excluded
    lanes (the run_tpc_fast discipline).  One K2 launch per round.

    CONTRACT: valid only for single-instance ERB state0 (one originator
    per instance), where every defined sender floods the originator's
    value — see ErbHist's contract note; feeding multi-writer initial
    states would diverge from the general engine silently."""
    S, n = mix.crashed.shape
    rnd = ErbHist(n_values)

    def counts_fn(state, k, done, r):
        colmask, side_r, p8, salt0, salt1r = round_params(mix, r)
        payload = rnd.payload(state, k)
        counts = fused.hist_exchange(
            payload, ~done, colmask & state.x_def,  # guarded broadcast
            None, side_r, salt0, salt1r, p8, rnd.num_values, mode=mode,
        ).to(torch.int32)
        return subtract_self_delivery(
            counts, payload, (~done) & ~state.x_def, rnd.num_values)

    return hist_scan(rnd, state0, lambda s: s.delivered, max_rounds, n,
                     counts_fn)


def mix_ho(mix: FaultMix, r) -> torch.Tensor:
    """[S, n(recv), n(send)] HO matrix for round r — the hash-mode link
    formula (ops.fused.ho_link_mask, the one shared implementation) over
    the whole mix, for fused paths whose exchange is not histogram-shaped
    (the bitset family).  Bit-identical to the per-scenario replay
    (scenarios.from_fault_params; round_tpu/engine/fast.py::mix_ho)."""
    colmask, side_r, p8, salt0, salt1r = round_params(mix, r)
    return fused.ho_link_mask(colmask, side_r, salt0, salt1r, p8)


def _ho_round_stats(get_ho: Callable, max_rounds: int) -> dict:
    """THE per-round HO-mask reducer both stat surfaces share
    (round_tpu/engine/fast.py::_ho_round_stats): `get_ho(r)` returns the
    round-r mask with receiver rows on the last-but-one axis and senders
    last.

    round_tpu takes float32 means of the bool mask and of the int32 mailbox
    sizes (XLA sums them in float32).  Here the 0/1 entries and the sizes
    are summed exactly as int64 and the sum is divided, as float32, by the
    element count as a float32 tensor on the same device (a tensor, not a
    Python scalar: CUDA divides by a scalar as a product with its
    reciprocal).  The bits agree with round_tpu's wherever XLA's float32
    sum is exact, i.e. while the sum stays below 2^24; above that XLA's
    own answer depends on its reduction order and the two may differ in
    the last places."""
    import numpy as np

    density, heard_mean, heard_min = [], [], []
    for r in range(max_rounds):
        ho = torch.as_tensor(get_ho(r))
        heard = ho.sum(dim=-1, dtype=torch.int64)  # per-receiver mailbox size
        dev = ho.device

        def mean(total, count):
            return (total.to(torch.float32)
                    / torch.tensor(float(count), dtype=torch.float32,
                                   device=dev))

        density.append(mean(heard.sum(), ho.numel()))
        heard_mean.append(mean(heard.sum(), heard.numel()))
        heard_min.append(heard.min().to(torch.int32))

    def stack(xs, dtype):
        if not xs:
            return np.zeros((0,), dtype=dtype)
        return torch.stack(xs).cpu().numpy()

    return {
        "density": stack(density, np.float32),
        "heard_mean": stack(heard_mean, np.float32),
        "heard_min": stack(heard_min, np.int32),
    }


def mix_ho_stats(mix: FaultMix, max_rounds: int) -> dict:
    """Per-round statistics of the HO masks the fused path derives from
    `mix` (hash mode — the bit-exact link formula, mix_ho;
    round_tpu/engine/fast.py::mix_ho_stats): who heard whom in round r,
    aggregated over the scenario batch, one round's [S, n, n] mask at a
    time.

    Returns numpy arrays, one entry per round:
      density     [T] float32 — delivered-link fraction over all S·n·n links;
      heard_mean  [T] float32 — mean mailbox size per receiver;
      heard_min   [T] int32 — smallest mailbox any receiver saw (the
                  quorum-risk diagnostic).

    hw-mode runs have no replayable mask, so the stats always describe the
    hash-mode schedule of the same mix."""
    return _ho_round_stats(lambda r: mix_ho(mix, r), max_rounds)


def sampler_ho_stats(sampler: Callable, key, max_rounds: int) -> dict:
    """mix_ho_stats for a plain HO sampler ((key, r) -> [n, n] bool, the
    engine/scenarios.py families): same per-round density / heard_mean /
    heard_min dict, same shared reducer
    (round_tpu/engine/fast.py::sampler_ho_stats)."""
    return _ho_round_stats(lambda r: sampler(key, r), max_rounds)


class LatticeHist(HistRound):
    """Lattice agreement on the fused path (models/lattice.py semantics,
    LatticeAgreement.scala:32-67; round_tpu/engine/fast.py::LatticeHist):
    the [m]-bit set payload rides bit-plane matmuls instead of per-receiver
    mailbox folds.

    counts layout ([S, m+1, n]): plane 0 = #heard senders whose proposal
    EQUALS the receiver's (equality via a Hamming-distance matmul pair,
    M = P·(1-P)ᵀ + (1-P)·Pᵀ, eq ⇔ M = 0); planes 1..m = per-bit heard
    counts, whose >0 test is the join (union = OR across heard sets)."""

    def __init__(self, m: int):
        self.num_values = m + 1
        self.m = m

    def payload(self, state, k: int = 0):
        return state.proposed                              # [S, n, m] bool

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        same = counts[:, 0, :]                             # [S, n]
        or_any = counts[:, 1:, :] > 0                      # [S, m, n]
        joined = state.proposed | or_any.transpose(1, 2)
        deciding = state.active & (same > n // 2)
        newly = deciding & ~state.decided
        grow = state.active & ~deciding
        state = state.replace(
            active=grow,
            proposed=torch.where(grow[..., None], joined, state.proposed),
            decided=state.decided | deciding,
            decision=torch.where(newly[..., None], state.proposed,
                                 state.decision),
        )
        return state, deciding


def lattice_counts(deliver, P_recv, P_send) -> torch.Tensor:
    """The lattice count planes ([.., m+1, n_recv] int32) from a delivery
    mask and the receiver/sender proposal matrices — ONE implementation
    shared by the single-device runner (P_recv = P_send) and the
    receiver-sharded path (P_recv = local slice, P_send = the gathered full
    matrix): plane 0 = #heard equal proposals (Hamming matmul pair), planes
    1..m = per-bit heard counts (the join).  The products run in float32 on
    0/1 operands, exact below 2^24 (round_tpu/engine/fast.py::
    lattice_counts)."""
    Pr = P_recv.to(torch.float32)
    Ps = P_send.to(torch.float32)
    ham = (torch.matmul(Pr, (1 - Ps).transpose(-1, -2))
           + torch.matmul(1 - Pr, Ps.transpose(-1, -2)))   # [.., j, i]
    eq = ham == 0
    same = (deliver & eq).sum(dim=-1, dtype=torch.int32)
    orc = torch.matmul(deliver.to(torch.float32), Ps).transpose(-1, -2)
    return torch.cat([same[..., None, :], orc.to(torch.int32)], dim=-2)


def run_lattice_fast(state0, mix: FaultMix, max_rounds: int):
    """Lattice agreement over the fused bitset exchange (round_tpu/engine/
    fast.py::run_lattice_fast): three [n, m]-class matmuls per
    scenario-round (two Hamming halves + the OR-count pass), through the
    shared hist_scan scaffolding.  Lane-exact against the general engine.
    Hash links only, as in round_tpu: the dense mask is the one the general
    engine replays."""
    S, n = mix.crashed.shape
    rnd = LatticeHist(state0.proposed.shape[-1])

    def counts_fn(state, k, done, r):
        return lattice_counts(_deliver(mix, r, done), state.proposed,
                              state.proposed)

    return hist_scan(rnd, state0, lambda s: s.decided, max_rounds, n,
                     counts_fn)


def _deliver(mix: FaultMix, r: int, done: torch.Tensor) -> torch.Tensor:
    """Round r's [S, j(recv), i(send)] delivery: the hash-mode HO mask with
    exited senders silenced."""
    return mix_ho(mix, r) & (~done)[:, None, :]


def _bmm01(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 batched product of 0/1 operands.  CUDA has no integer bmm, so
    it runs in float32: every sum is a count ≤ n < 2^24, exact (TF32 keeps
    0 and 1 exact too), and the result is never a half-precision type."""
    return torch.bmm(a.to(torch.float32), b.to(torch.float32)).to(
        torch.int32)


class EsfdHist(HistRound):
    """◇S failure detector on the fused path (models/failure_detector.py
    semantics; round_tpu/engine/fast.py::EsfdHist): the suspected-set
    broadcast rides bit-plane OR counts (planes 0..n-1 = per-peer
    accusation counts) stacked with the raw delivery planes (planes
    n..2n-1 = who this receiver heard — sender identity as a one-hot
    'value').  The update is three masked writes."""

    def __init__(self, n: int, hysteresis: int):
        self.num_values = 2 * n
        self.h = hysteresis

    # no payload() override: the counts_fn builds its planes directly, and
    # a stray run_hist(EsfdHist) hits the base NotImplementedError

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        h = self.h
        accused = (counts[:, :n, :] > 0).transpose(1, 2)    # [S, j, p]
        present = (counts[:, n:, :] > 0).transpose(1, 2)    # [S, j, p]
        ls = torch.clamp(state.last_seen + 1, max=h + 1)
        ls = torch.where(accused & ~present, h + 1, ls)
        ls = torch.where(present, 0, ls).to(torch.int32)
        return state.replace(last_seen=ls), torch.zeros_like(
            size, dtype=torch.bool)


def run_esfd_fast(state0, mix: FaultMix, max_rounds: int, hysteresis: int):
    """◇S through the bitset exchange (round_tpu/engine/fast.py::
    run_esfd_fast): per round one [S, j, i] × [S, i, p] product of the
    delivery and the suspicion matrices (float32 on 0/1 operands, exact)
    for the accusations, plus the delivery planes themselves.  Hash links
    only, as in round_tpu; lane-exact against the general engine.

    `done` never fires (a failure detector runs forever); decided_fn
    reports all-false lanes."""
    S, n = mix.crashed.shape

    def counts_fn(state, k, done, r):
        deliver = _deliver(mix, r, done)                      # [S, j, i]
        sus = state.last_seen > hysteresis                    # [S, i, p]
        orc = _bmm01(deliver, sus).transpose(1, 2)            # [S, p, j]
        heard = deliver.transpose(1, 2).to(torch.int32)       # [S, i, j]
        return torch.cat([orc, heard], dim=1)                 # [S, 2n, j]

    rnd = EsfdHist(n, hysteresis)
    return hist_scan(
        rnd, state0,
        lambda s: torch.zeros(s.last_seen.shape[:2], dtype=torch.bool,
                              device=s.last_seen.device),
        max_rounds, n, counts_fn)


class ThetaHist(HistRound):
    """Θ-model round synchronizer on the fused path (models/theta.py
    semantics; round_tpu/engine/fast.py::ThetaHist): the Some(round)/None
    broadcast rides delivery-WEIGHTED planes — plane p carries round[p]+2
    where sender p fired and delivered, 0 otherwise — so the per-peer
    heard-max is one masked maximum, no mailbox pytree."""

    num_values = 1  # planes are sender-indexed, not value-indexed

    def __init__(self, f: int, theta: float):
        self.f = f
        self.theta = float(theta)

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        from round_tpu_torch.models.theta import _next_round_at

        vals = counts.transpose(1, 2)                       # [S, j, p]
        heard = torch.where(
            vals > 0, torch.maximum(state.heard, vals - 2), state.heard)
        firing = r == state.next_round_at                   # [S, j]
        new_round = torch.where(firing, state.round + 1, state.round)
        nra = torch.where(firing, _next_round_at(self.theta, new_round),
                          state.next_round_at)
        state = state.replace(round=new_round, next_round_at=nra,
                              heard=heard)
        return state, torch.zeros_like(firing)


def run_theta_fast(state0, mix: FaultMix, max_rounds: int, f: int,
                   theta: float):
    """Θ-model through the fused exchange (round_tpu/engine/fast.py::
    run_theta_fast): one [S, j, p] weighted plane per round (deliver ∧
    sender fired, weighted by the sender's logical round).  Hash links
    only; lane-exact against the general engine."""
    S, n = mix.crashed.shape
    rnd = ThetaHist(f, theta)

    def counts_fn(state, k, done, r):
        deliver = _deliver(mix, r, done)                      # [S, j, p]
        defined = r == state.next_round_at                    # [S, p] fired
        w = torch.where(defined, state.round + 2, 0)          # [S, p]
        planes = deliver.to(torch.int32) * w[:, None, :]      # [S, j, p]
        return planes.transpose(1, 2)                         # [S, p, j]

    return hist_scan(
        rnd, state0,
        lambda s: torch.zeros(s.round.shape, dtype=torch.bool,
                              device=s.round.device),
        max_rounds, n, counts_fn)


class PbftHist(HistRound):
    """PBFT-style byzantine consensus on the fused path (models/pbft.py Bcp
    semantics; round_tpu/engine/fast.py::PbftHist): 3-subround phases.

      k=0 pre-prepare: three planes — heard-the-coordinator, the
        coordinator's request and its claimed digest (adoption, digest
        recheck, abort-to-null on silence/mismatch);
      k=1 prepare: one plane — #heard senders whose (ok, digest) matches
        the receiver's digest;
      k=2 commit: one plane — #heard PREPARED senders with a matching
        digest; decide x or null, terminate either way."""

    num_values = 3
    phase_len = 3
    needs_lane_ids = True  # the coordinator test is a lane-identity compare

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None,
                      lane_ids=None):
        from round_tpu_torch.models.pbft import DECIDE_NULL, digest

        no_exit = torch.zeros_like(size, dtype=torch.bool)
        if k == 0:
            coord = (r // 3) % n
            got = counts[:, 0, :] > 0
            req = counts[:, 1, :]
            claimed = counts[:, 2, :]
            recomputed = digest(req)
            is_coord = lane_ids[None, :] == coord
            adopt = got & ~is_coord
            x = torch.where(adopt, req, state.x)
            dig = torch.where(adopt, recomputed, state.dig)
            valid = torch.where(adopt, recomputed == claimed, state.valid)
            fail = ~got | ~valid
            state = ghost_decide(state, fail,
                                 torch.full_like(state.decision, DECIDE_NULL))
            return state.replace(x=x, dig=dig, valid=valid), fail
        confirmed = counts[:, 0, :]
        if k == 1:
            return state.replace(prepared=confirmed > 2 * n // 3), no_exit
        committed = confirmed > 2 * n // 3
        state = ghost_decide(state, torch.ones_like(committed),
                             torch.where(committed, state.x, DECIDE_NULL))
        return state, ~no_exit


def run_pbft_fast(state0, mix: FaultMix, max_rounds: int = 3):
    """PBFT through the fused exchange (round_tpu/engine/fast.py::
    run_pbft_fast): guarded sends AND into the delivery directly (the mask
    is explicit here, so there is no hard-wired self-delivery to correct),
    digest agreement as outer scalar equality, masked row sums.  Hash links
    only; lane-exact against the general engine on FaultMix families."""
    S, n = mix.crashed.shape
    rnd = PbftHist()

    def counts_fn(state, k, done, r):
        deliver = _deliver(mix, r, done)                      # [S, j, i]
        if k == 0:
            coord = (r // 3) % n
            # only the coordinator's column is read, and its own send
            # guard (id == coord) is trivially true — no column mask
            g = deliver[:, :, coord].to(torch.int32)          # [S, j]
            req_c = state.x[:, coord]                         # [S]
            dig_c = state.dig[:, coord]                       # [S]
            return torch.stack([g, req_c[:, None].expand_as(g),
                                dig_c[:, None].expand_as(g)], dim=1)
        dig_eq = state.dig[:, :, None] == state.dig[:, None, :]  # [S, j, i]
        ok = state.valid if k == 1 else state.prepared
        conf = (deliver & ok[:, None, :] & dig_eq).sum(dim=2,
                                                        dtype=torch.int32)
        return conf[:, None, :]

    return hist_scan(rnd, state0, lambda s: s.decided, max_rounds, n,
                     counts_fn)


def run_pbft_vc_fast(state0, mix: FaultMix, max_rounds: int):
    """PBFT WITH primary rotation on the fused path (models/pbft.py
    PbftViewChange semantics; round_tpu/engine/fast.py::run_pbft_vc_fast):
    6-round phases as batched plane ops over the whole [S, n] batch.
    Per-lane views make the coordinator a per-receiver gather
    (coord = view % n), the distributedState accumulators ride [S, n, n]
    planes, and the ack-confirmation count is one [S, j, i, m] reduction
    (m = n: byzantine groups are small), summed as int32.  Hash links only;
    lane-exact against the general engine.

    Returns (state, done, decided_round) like hist_scan."""
    from round_tpu_torch.models.pbft import cert_digest, digest

    S, n = mix.crashed.shape
    dev = mix.crashed.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)[None, :]  # [1, n]
    maj23, maj13 = 2 * n // 3, n // 3
    no_exit = torch.zeros((S, n), dtype=torch.bool, device=dev)

    def gather(a, idx):
        """a[s, idx[s, j]] for per-receiver indices idx [S, n]."""
        return torch.gather(a, 1, idx.to(torch.int64))

    def col(deliver, idx):
        """deliver[s, j, idx[s, j]]: did receiver j hear its own pick."""
        return torch.gather(deliver, 2, idx.to(torch.int64)[:, :, None])[
            ..., 0]

    def same(a):
        """[S, j, i]: a[s, j] == a[s, i]."""
        return a[:, :, None] == a[:, None, :]

    def pre_prepare(st, deliver):
        cj = (st.view % n).to(torch.int32)                  # receiver's coord
        sguard = (lane == cj) & ~st.vc_active               # at the sender
        got = col(deliver, cj) & gather(sguard, cj) \
            & (gather(st.view, cj) == st.view)
        req_c = gather(st.x, cj)
        claimed = gather(st.dig, cj)
        recomputed = digest(req_c)

        active = ~st.vc_active & ~st.decided
        adopt = got & (lane != cj) & active
        valid = torch.where(adopt, recomputed == claimed, st.valid)
        fail = active & (~got | ~valid)
        return st.replace(
            x=torch.where(adopt, req_c, st.x),
            dig=torch.where(adopt, recomputed, st.dig),
            valid=valid,
            vc_active=st.vc_active | fail,
            next_view=torch.where(fail, st.view + 1, st.next_view),
        ), no_exit

    def prepare(st, deliver):
        pred = st.valid[:, None, :] & same(st.dig) & same(st.view)
        conf = (deliver & (~st.vc_active)[:, None, :] & pred).sum(
            dim=2, dtype=torch.int32)
        prepared = (conf > maj23) & ~st.vc_active & ~st.decided
        return st.replace(
            prepared=prepared,
            prep_req=torch.where(prepared, st.x, st.prep_req),
            prep_view=torch.where(prepared, st.view, st.prep_view),
        ), no_exit

    def commit(st, deliver):
        sguard = st.prepared & ~st.vc_active
        conf = (deliver & sguard[:, None, :] & same(st.dig)
                & same(st.view)).sum(dim=2, dtype=torch.int32)
        active = ~st.vc_active & ~st.decided
        committed = (conf > maj23) & active
        st = ghost_decide(st, committed, st.x)
        fail = active & ~committed
        return st.replace(
            vc_active=st.vc_active | fail,
            next_view=torch.where(fail, st.view + 1, st.next_view),
        ), st.decided

    def view_change(st, deliver):
        match = deliver & st.vc_active[:, None, :] & same(st.next_view)
        keep = st.vc_active & ~st.decided
        pr_b = st.prep_req[:, None, :].expand_as(st.vc_req)
        pv_b = st.prep_view[:, None, :].expand_as(st.vc_pv)
        return st.replace(
            vc_heard=torch.where(keep[:, :, None], match,
                                 torch.zeros_like(st.vc_heard)),
            vc_req=torch.where(keep[:, :, None], pr_b, st.vc_req),
            vc_pv=torch.where(keep[:, :, None] & match, pv_b,
                              torch.full_like(st.vc_pv, -1)),
        ), no_exit

    def view_change_ack(st, deliver):
        my_cert = cert_digest(st.vc_req, st.vc_pv)          # [S, n, m]
        ackd = torch.where(st.vc_heard, my_cert, -1)
        acker_ok = deliver & st.vc_active[:, None, :] & same(st.next_view)
        matches = acker_ok[:, :, :, None] \
            & (ackd[:, None, :, :] == my_cert[:, :, None, :])  # [S,j,i,m]
        confirm = matches.sum(dim=2, dtype=torch.int32)        # [S,j,m]
        confirmed = st.vc_heard & (confirm > maj13)
        quorum = confirmed.sum(dim=2, dtype=torch.int32) > maj23

        has_prep = confirmed & (st.vc_pv >= 0)
        key = torch.where(has_prep, st.vc_pv, -2)
        at_max = key == key.max(dim=2, keepdim=True).values
        # the first maximal index, written out (no argmax of a bool)
        best = torch.where(at_max, lane[:, None, :], n).min(dim=2).values
        sel = torch.where(
            has_prep.any(dim=2),
            torch.gather(st.vc_req, 2, best.to(torch.int64)[..., None])[
                ..., 0],
            st.x)
        keep = st.vc_active & ~st.decided
        return st.replace(
            sel_req=torch.where(keep, sel, st.sel_req),
            nv_ok=torch.where(keep, quorum, st.nv_ok),
        ), no_exit

    def new_view(st, deliver):
        nc = (st.next_view % n).to(torch.int32)
        sguard = st.vc_active & (lane == nc) & st.nv_ok
        got = col(deliver, nc) & gather(sguard, nc) \
            & (gather(st.next_view, nc) == st.next_view)
        sel = gather(st.sel_req, nc)

        keep = st.vc_active & ~st.decided
        install = keep & got
        retry = keep & ~got
        return st.replace(
            view=torch.where(install, st.next_view, st.view),
            x=torch.where(install, sel, st.x),
            dig=torch.where(install, digest(sel), st.dig),
            valid=torch.where(install, True, st.valid),
            prepared=torch.where(install, False, st.prepared),
            vc_active=torch.where(install, False, st.vc_active),
            next_view=torch.where(retry, st.next_view + 1, st.next_view),
        ), no_exit

    bodies = (pre_prepare, prepare, commit,
              view_change, view_change_ack, new_view)

    state = state0
    done = torch.zeros((S, n), dtype=torch.bool, device=dev)
    dround = torch.full((S, n), -1, dtype=torch.int32, device=dev)
    for r in range(max_rounds):
        new_state, exit_ = bodies[r % 6](state, _deliver(mix, r, done))
        active = ~done
        state = tree_where(active, new_state, state)
        done = done | (active & exit_)
        dround = torch.where(state.decided & (dround < 0), r, dround)
    return state, done, dround


class MutexHist(HistRound):
    """Dijkstra's self-stabilizing token ring on the fused path
    (models/mutex.py semantics; round_tpu/engine/fast.py::MutexHist): each
    lane reads exactly its LEFT neighbour — one diagonal-shifted gather of
    the delivery matrix plus the rolled value plane, no mailbox fold.  A
    lane that heard nothing keeps x and holds no token (the EventRound
    timeout path)."""

    num_values = 2
    needs_lane_ids = True  # process 0's increment rule is identity-based

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None,
                      lane_ids=None):
        got = counts[:, 0, :] > 0
        x_left = counts[:, 1, :]
        is_zero = lane_ids[None, :] == 0
        token = torch.where(is_zero, state.x == x_left,
                            state.x != x_left) & got
        new_x = torch.where(
            is_zero,
            torch.where(token, (state.x + 1) % (n + 1), state.x),
            torch.where(token, x_left, state.x),
        )
        state = state.replace(x=torch.where(got, new_x, state.x),
                              has_token=token)
        return state, torch.zeros_like(got)


def run_mutex_fast(state0, mix: FaultMix, max_rounds: int):
    """The token ring through the fused exchange (round_tpu/engine/fast.py::
    run_mutex_fast): plane 0 = heard the left neighbour (one gather of the
    delivery matrix at the ring shift), plane 1 = the left neighbour's
    value.  Hash links only; lane-exact against the general engine's
    EventRound."""
    S, n = mix.crashed.shape
    rnd = MutexHist()
    left = (torch.arange(n, device=mix.crashed.device) - 1) % n

    def counts_fn(state, k, done, r):
        deliver = _deliver(mix, r, done)                      # [S, j, i]
        got = torch.gather(deliver, 2,
                           left[None, :, None].expand(S, n, 1))[..., 0]
        x_left = state.x[:, left]                             # [S, j]
        return torch.stack([got.to(torch.int32), x_left], dim=1)

    return hist_scan(
        rnd, state0,
        lambda s: torch.zeros(s.x.shape, dtype=torch.bool, device=s.x.device),
        max_rounds, n, counts_fn)


class CgolHist(HistRound):
    """Conway's Game of Life on the fused path (models/gameoflife.py;
    round_tpu/engine/fast.py::CgolHist): one alive-neighbour count plane
    per round; the torus overlay is a static dest mask ANDed into the
    delivery (its empty diagonal also cancels the HO formula's
    self-loop)."""

    num_values = 1

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        alive_nbrs = counts[:, 0, :]
        survive = state.alive & ((alive_nbrs == 2) | (alive_nbrs == 3))
        born = ~state.alive & (alive_nbrs == 3)
        return state.replace(alive=survive | born), torch.zeros_like(born)


def run_gol_fast(state0, mix: FaultMix, neighbours, max_rounds: int):
    """Game of Life through the fused exchange (round_tpu/engine/fast.py::
    run_gol_fast): the overlay is a point-to-multipoint dest mask, applied
    as one AND on the delivery; the B3/S23 count is one [n, n] masked
    matvec a scenario (float32 on 0/1 operands, exact).  Hash links only;
    lane-exact against the general engine, lossy overlays included."""
    S, n = mix.crashed.shape
    rnd = CgolHist()
    dest_t = torch.as_tensor(neighbours, device=mix.crashed.device).to(
        torch.bool).T[None]                                   # [1, j, i]

    def counts_fn(state, k, done, r):
        deliver = _deliver(mix, r, done) & dest_t
        return _bmm01(deliver, state.alive[:, :, None])[..., 0][:, None, :]

    return hist_scan(
        rnd, state0,
        lambda s: torch.zeros(s.alive.shape, dtype=torch.bool,
                              device=s.alive.device),
        max_rounds, n, counts_fn)


class KSetESHist(HistRound):
    """Early-stopping k-set agreement on the fused path
    (KSetEarlyStopping.scala:8-46; round_tpu/engine/fast.py::KSetESHist;
    general-engine model models/kset.py::KSetESRound).

    The (est, canDecide) broadcast rides ONE histogram over a doubled
    domain, code = est·2 + can, so K2 runs at V = 2·n_values.  The update
    decodes straight off the counts: est folds to
    min{code >> 1 : counts[code] > 0} (the mailbox masked_min), canDecide to
    an any-odd-code test plus the fewer-than-k-dropouts trigger
    (last_nb - size < k)."""

    def __init__(self, n_values: int, t: int, k: int):
        self.num_values = 2 * n_values
        self.t = t
        self.k = k

    def payload(self, state, k: int = 0):
        return state.est * 2 + state.can_decide.to(torch.int32)

    def update_counts(self, state, counts, size, r, n, k: int = 0, coin=None):
        codes = torch.arange(self.num_values, dtype=torch.int32,
                             device=counts.device)[None, :, None]
        deciding = (r > self.t // self.k) | state.can_decide
        heard = counts > 0
        est_m = torch.where(heard, codes >> 1, 2**31 - 1).min(
            dim=1).values.to(state.est.dtype)
        can_rx = (heard & (codes % 2 == 1)).any(dim=1)
        can = can_rx | (state.last_nb - size < self.k)
        state = ghost_decide(state, deciding, state.est)
        state = state.replace(
            est=torch.where(deciding, state.est, est_m),
            can_decide=torch.where(deciding, state.can_decide, can),
            last_nb=torch.where(deciding, state.last_nb, size),
        )
        return state, deciding


def hist_scan(
    rnd: HistRound,
    state0,
    decided_fn: Callable,
    max_rounds: int,
    n: int,
    counts_fn: Callable,
    coin_fn: Optional[Callable] = None,
    lane_ids: Optional[torch.Tensor] = None,
    ho_fn: Optional[Callable] = None,
):
    """The round-step scaffolding every histogram engine shares
    (round_tpu/engine/fast.py::hist_scan): subround dispatch, exit/freeze
    bookkeeping (exited lanes stop sending and their state freezes) and
    decided_round recording.  Engines differ only in how counts are
    produced:

      counts_fn(state, k, done, r) -> counts [.., V, lanes] int32
      coin_fn(r) -> per-lane coin matrix (rnd.needs_coin engines)

    Shared by run_hist (the fused exchange on one device) and
    parallel.mesh.run_hist_proc_sharded (receiver-sharded count blocks);
    `n` is the GLOBAL group size (quorum thresholds), which may exceed the
    local lane axis.  `lane_ids` are the global ids of the local lanes
    (default: arange), passed to update_counts for rounds with
    needs_lane_ids.

    ``ho_fn(r) -> block`` selects the cross-round pipelined form: round
    r+1's HO block is produced before round r's update (it depends on the
    round index alone, so on the card its kernels are queued ahead of the
    count and the update) and counts_fn is called as
    counts_fn(state, k, done, r, block).  ``ho_fn=None`` is the
    straight-line loop: counts_fn makes its own mask in-round.  The two
    forms are bit-identical; only when the block is computed moves.

    A Python loop over rounds (round_tpu: lax.scan)."""
    lanes_like = decided_fn(state0)
    done = torch.zeros(lanes_like.shape, dtype=torch.bool,
                       device=lanes_like.device)
    decided_round = torch.full(lanes_like.shape, -1, dtype=torch.int32,
                               device=lanes_like.device)
    extra = {}
    if rnd.needs_lane_ids:
        extra["lane_ids"] = (
            torch.arange(lanes_like.shape[-1], dtype=torch.int32,
                         device=lanes_like.device)
            if lane_ids is None else lane_ids)
    state = state0
    ho = ho_fn(0) if ho_fn is not None and max_rounds > 0 else None
    for r in range(max_rounds):
        coin = coin_fn(r) if coin_fn is not None else None
        k = r % rnd.phase_len
        if ho_fn is None:
            counts = counts_fn(state, k, done, r)
        else:
            # the carried block is this round's; the next round's is
            # produced before this round's count and update
            block, ho = ho, ho_fn(r + 1)
            counts = counts_fn(state, k, done, r, block)
            del block
        size = counts.sum(dim=1, dtype=torch.int32)
        new_state, exit_ = rnd.update_counts(state, counts, size, r, n, k=k,
                                             coin=coin, **extra)
        # frozen lanes keep their state; exits only count for active lanes
        active = ~done
        state = tree_where(active, new_state, state)
        done = done | (active & exit_)
        dec = decided_fn(state)
        decided_round = torch.where(dec & (decided_round < 0), r,
                                    decided_round)
    return state, done, decided_round


def hash_coin_fn(mix: FaultMix, lane_ids: torch.Tensor) -> Callable:
    """coin_fn for hist_scan: the deterministic per-(scenario, lane, round)
    hash coin at the given global lane ids."""
    def coin(r):
        return fused.hash_coin(mix.salt0[:, None], mix.salt1[:, None], r,
                               lane_ids[None, :])
    return coin


def run_hist(
    rnd: HistRound,
    state0,
    decided_fn: Callable,
    mix: FaultMix,
    max_rounds: int,
    mode: str = "hw",
    dot: str = "i8",
):
    """`max_rounds` fused rounds over the full scenario batch, one K2 launch
    per round on the card (round_tpu/engine/fast.py::run_hist).

    state0 leaves are [S, n, ...].  Returns (state, done [S, n],
    decided_round [S, n]).  Exited lanes stop sending and freeze.  Counts
    ``engine.hist_runs`` at Python entry (obs.metrics.METRICS), as
    round_tpu does."""
    METRICS.counter("engine.hist_runs").inc()
    S, n = mix.crashed.shape
    V = rnd.num_values

    def counts_fn(state, k, done, r):
        colmask, side_r, p8, salt0, salt1r = round_params(mix, r)
        return fused.hist_exchange(
            rnd.payload(state, k), ~done, colmask,
            None,  # rowmask: broadcast rounds select every receiver
            side_r, salt0, salt1r, p8, V, mode=mode, dot=dot,
        ).to(torch.int32)

    coin_fn = (
        hash_coin_fn(mix, torch.arange(n, dtype=torch.int32,
                                       device=mix.crashed.device))
        if rnd.needs_coin else None
    )
    return hist_scan(rnd, state0, decided_fn, max_rounds, n, counts_fn,
                     coin_fn)


def run_otr_loop(
    rnd: OtrHist,
    state0,
    mix: FaultMix,
    max_rounds: int,
    mode: str = "hw",
    dot: str = "i8",
):
    """The flagship fast path: the whole OTR run as ONE kernel launch
    (ops.fused.otr_loop) — state stays on chip across rounds
    (round_tpu/engine/fast.py::run_otr_loop).

    Drop-in for run_hist(OtrHist(...), fresh state0, ...) in the same
    mode: same (state, done, decided_round), bit for bit.  `state0` must be a FRESH OtrState
    (decided/decision/after at their init values); only its `x` enters the
    kernel.  A resumed state is refused.  Counts ``engine.loop_runs`` at
    Python entry, as round_tpu does."""
    from round_tpu_torch.models.otr import OtrState

    METRICS.counter("engine.loop_runs").inc()
    _require_fresh(
        not (bool(state0.decided.any())
             or bool((state0.after != rnd.after_decision).any())),
        "otr",
    )
    x, dec, decision, after, done, dround = fused.otr_loop(
        state0.x, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
        mix.rotate_down, mix.p8, mix.salt0, mix.salt1,
        num_values=rnd.num_values, rounds=max_rounds,
        after_decision=rnd.after_decision, mode=mode, dot=dot,
    )
    state = OtrState(x=x, decided=dec, decision=decision, after=after)
    return state, done, dround


def _mix_args(mix: FaultMix):
    """The mix fields in the argument order of ops.fused.hist_loop after
    x0 (round_tpu/engine/fast.py::_mix_args)."""
    return (mix.crashed, mix.side, mix.crash_round, mix.heal_round,
            mix.rotate_down, mix.p8, mix.salt0, mix.salt1)


def _require_fresh(ok: bool, what: str):
    """Refuse a resumed state0 (round_tpu/engine/fast.py::_require_fresh)."""
    if not ok:
        raise ValueError(
            f"run_{what}_loop requires a fresh state0 (nothing decided, "
            "round variables at their init values); resume partial runs "
            "with run_hist instead"
        )


def run_floodmin_loop(
    rnd: FloodMinHist,
    state0,
    mix: FaultMix,
    max_rounds: int,
    mode: str = "hw",
    dot: str = "i8",
):
    """FloodMin's whole run as one K1 launch (ops.fused.FloodMinLoop;
    round_tpu/engine/fast.py::run_floodmin_loop) — drop-in for
    run_hist(FloodMinHist(...), fresh state0, ...): same
    (state, done, decided_round).  A resumed state0 is refused."""
    from round_tpu_torch.models.floodmin import FloodMinState

    _require_fresh(not bool(state0.decided.any()), "floodmin")
    (x, dec, decision), done, dround = fused.hist_loop(
        fused.FloodMinLoop(num_values=rnd.num_values, f=rnd.f),
        state0.x, *_mix_args(mix), rounds=max_rounds, mode=mode, dot=dot,
    )
    state = FloodMinState(x=x, decided=dec != 0, decision=decision)
    return state, done, dround


def run_benor_loop(
    rnd: BenOrHist,
    state0,
    mix: FaultMix,
    max_rounds: int,
    mode: str = "hw",
    dot: str = "i8",
):
    """Ben-Or's whole run as one K1 launch (ops.fused.BenOrLoop, two
    subrounds per phase dispatched in the kernel;
    round_tpu/engine/fast.py::run_benor_loop) — drop-in for
    run_hist(BenOrHist(), fresh state0, ...); the coin is the deterministic
    hash coin in both paths.  A resumed state0 is refused."""
    from round_tpu_torch.models.benor import BenOrState

    _require_fresh(
        not (bool(state0.decided.any()) or bool(state0.can_decide.any())
             or bool((state0.vote != -1).any())),
        "benor",
    )
    (x, can, vote, dec, decision), done, dround = fused.hist_loop(
        fused.BenOrLoop(), state0.x.to(torch.int32), *_mix_args(mix),
        rounds=max_rounds, mode=mode, dot=dot,
    )
    state = BenOrState(x=x != 0, can_decide=can != 0, vote=vote,
                       decided=dec != 0, decision=decision != 0)
    return state, done, dround
