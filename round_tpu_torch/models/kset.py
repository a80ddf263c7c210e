"""k-set agreement: KSetAgreement (map-merging) and KSetEarlyStopping.

Port of round_tpu/models/kset.py.

KSetAgreement (example/KSetAgreement.scala:21-67): each process carries a
partial map ``t: ProcessID -> Int`` of known initial values (initially just
its own).  Every round broadcast (decider, t); a process that sees a decider
adopts that decider's map; a process whose map is shared by more than n-k
senders becomes a decider; otherwise it merges all received maps.  A decider
broadcasts once more, then decides min(t.values).  Model: n > 2(k-1), crash
faults f < k (KSetAgreement.scala:73-79).

The ``Map[ProcessID,Int]`` payload becomes a [n] value vector + [n]
validity mask, so the wire tensor is [n, n, n]-shaped per round.  Merges and
``find`` break ties toward the smallest sender id, as in round_tpu.

KSetEarlyStopping (example/KSetEarlyStopping.scala:8-46, after
Mostefaoui-Raynal): broadcast (est, canDecide); est := min received; decide
when r > t/k or canDecide, where canDecide propagates or triggers when fewer
than k processes dropped out since the last round.  Its fused form is
engine.fast.KSetESHist, through the K2 kernel.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.ops.mailbox import Mailbox, first_true
from round_tpu_torch.utils.tree import struct

_INT_MAX = 2**31 - 1


@struct
class KSetState:
    t_vals: torch.Tensor    # [n] int32 — known initial values (garbage if unknown)
    t_mask: torch.Tensor    # [n] bool — which pids are known
    decider: torch.Tensor   # bool
    decided: torch.Tensor   # bool (ghost)
    decision: torch.Tensor  # int32, -1 until decided


class KSetRound(Round):
    """The one round of map-merging k-set agreement
    (round_tpu/models/kset.py::KSetRound)."""

    def __init__(self, k: int):
        self.k = k

    def send(self, ctx: RoundCtx, state: KSetState):
        return broadcast(
            ctx,
            {"dec": state.decider, "vals": state.t_vals, "mask": state.t_mask},
        )

    def update(self, ctx: RoundCtx, state: KSetState, mbox: Mailbox):
        n, k = ctx.n, self.k
        present = mbox.mask                      # [n]
        s_dec = mbox.values["dec"]               # [n]
        s_vals = mbox.values["vals"]             # [n, n]
        s_mask = mbox.values["mask"]             # [n, n]

        # --- branch 1: already a decider -> decide min(t.values), exit
        own_min = torch.where(state.t_mask, state.t_vals, _INT_MAX).min()
        deciding = state.decider
        ctx.exit_at_end_of_round(deciding)

        # --- branch 2: adopt the map of the first (smallest-id) decider seen
        seen_dec = present & s_dec
        any_dec = seen_dec.any()
        src = first_true(seen_dec)
        adopt_vals, adopt_mask = s_vals[src], s_mask[src]

        # --- branch 3: same-map count (Map equality: same keys, same values)
        mask_eq = (s_mask == state.t_mask[None, :]).all(dim=1)
        vals_eq = torch.where(s_mask & state.t_mask[None, :],
                              s_vals == state.t_vals[None, :], True).all(dim=1)
        same = (present & mask_eq & vals_eq).to(torch.int32).sum(
            dtype=torch.int32)
        promote = same > n - k

        # --- branch 4: merge all received maps (union of masks; values from
        # the smallest sender id that knows the pid, else own)
        knows = present[:, None] & s_mask        # [sender, pid]
        any_know = knows.any(dim=0)              # [pid]
        first = first_true(knows.transpose(0, 1))  # [pid]
        merged_vals = torch.where(
            any_know, torch.gather(s_vals, 0, first[None, :])[0], state.t_vals)
        merged_mask = state.t_mask | any_know

        # combine branches (priority: decider > adopt > promote > merge)
        use_adopt = ~deciding & any_dec
        use_merge = ~deciding & ~any_dec & ~promote
        t_vals = torch.where(
            use_adopt, adopt_vals,
            torch.where(use_merge, merged_vals, state.t_vals))
        t_mask = torch.where(
            use_adopt, adopt_mask,
            torch.where(use_merge, merged_mask, state.t_mask))
        decider = deciding | use_adopt | (~deciding & ~any_dec & promote)
        state = ghost_decide(state, deciding, own_min.to(torch.int32))
        return state.replace(t_vals=t_vals, t_mask=t_mask, decider=decider)


class KSetAgreement(Algorithm):
    """k-set agreement by map merging (decisions span ≤ k distinct values;
    round_tpu/models/kset.py::KSetAgreement)."""

    def __init__(self, k: int = 2):
        self.k = k
        self.rounds = (KSetRound(k),)

    def make_init_state(self, ctx: RoundCtx, io) -> KSetState:
        n = ctx.n
        iv = torch.as_tensor(io["initial_value"]).to(torch.int32)
        me = torch.arange(n, device=iv.device) == ctx.id
        false = torch.zeros((), dtype=torch.bool, device=iv.device)
        return KSetState(
            t_vals=torch.where(me, iv, 0).to(torch.int32),
            t_mask=me,
            decider=false,
            decided=false,
            decision=torch.full((), -1, dtype=torch.int32, device=iv.device),
        )

    def decided(self, state: KSetState):
        return state.decided

    def decision(self, state: KSetState):
        return state.decision


@struct
class KSetESState:
    est: torch.Tensor       # int32
    can_decide: torch.Tensor
    last_nb: torch.Tensor   # int32 — |mailbox| of the previous round
    decided: torch.Tensor
    decision: torch.Tensor

    @classmethod
    def fresh(cls, init, S: int, n: int) -> "KSetESState":
        """[S, n]-batched undecided state from an [n] initial-value vector,
        on the device of ``init`` (the state KSetEarlyStopping's init gives
        every lane)."""
        init = torch.as_tensor(init)
        dev = init.device
        return cls(
            est=init.to(torch.int32).expand((S, n)).contiguous(),
            can_decide=torch.zeros((S, n), dtype=torch.bool, device=dev),
            last_nb=torch.full((S, n), n, dtype=torch.int32, device=dev),
            decided=torch.zeros((S, n), dtype=torch.bool, device=dev),
            decision=torch.full((S, n), -1, dtype=torch.int32, device=dev),
        )


class KSetESRound(Round):
    """The one round of early-stopping k-set agreement
    (round_tpu/models/kset.py::KSetESRound)."""

    def __init__(self, t: int, k: int):
        self.t = t
        self.k = k

    def send(self, ctx: RoundCtx, state: KSetESState):
        return broadcast(ctx, {"est": state.est, "can": state.can_decide})

    def update(self, ctx: RoundCtx, state: KSetESState, mbox: Mailbox):
        curr_nb = mbox.size()
        deciding = (ctx.r > self.t // self.k) | state.can_decide
        ctx.exit_at_end_of_round(deciding)

        est = mbox.masked_min(mbox.values["est"])
        can = mbox.exists(lambda m: m["can"]) | (state.last_nb - curr_nb
                                                 < self.k)
        state = ghost_decide(state, deciding, state.est)
        return state.replace(
            est=torch.where(deciding, state.est, est),
            can_decide=torch.where(deciding, state.can_decide, can),
            last_nb=torch.where(deciding, state.last_nb, curr_nb),
        )


class KSetEarlyStopping(Algorithm):
    """Early-stopping k-set agreement (t crash faults, decide by round
    t/k+1; round_tpu/models/kset.py::KSetEarlyStopping)."""

    def __init__(self, t: int = 2, k: int = 2):
        self.t = t
        self.k = k
        self.rounds = (KSetESRound(t, k),)

    def make_init_state(self, ctx: RoundCtx, io) -> KSetESState:
        est = torch.as_tensor(io["initial_value"]).to(torch.int32)
        false = torch.zeros((), dtype=torch.bool, device=est.device)
        return KSetESState(
            est=est,
            can_decide=false,
            last_nb=torch.full((), ctx.n, dtype=torch.int32,
                               device=est.device),
            decided=false,
            decision=torch.full((), -1, dtype=torch.int32, device=est.device),
        )

    def decided(self, state: KSetESState):
        return state.decided

    def decision(self, state: KSetESState):
        return state.decision
