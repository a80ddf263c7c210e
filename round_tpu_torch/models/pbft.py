"""PBFT-style single-decision byzantine consensus (pre-prepare / prepare /
commit with digest checks), and the same WITH view change.

Port of round_tpu/models/pbft.py.  Reference:
example/byzantine/test/Consensus.scala:26-165 (``Bcp``): 3-round phases
with coordinator ``coord = (r/3) % n``:

  pre-prepare: coord broadcasts (request, digest); receivers adopt the
    request, recompute the digest and null out on mismatch; a lane that
    fails to get a valid request decides null and stops.
  prepare: broadcast your digest; more than 2n/3 matches -> prepared.
  commit: the prepared broadcast the digest; more than 2n/3 matches ->
    decide(x), else decide(null).  The instance terminates either way.

``PbftViewChange`` composes those rounds with the three rounds of
example/byzantine/pbft/ViewChange.scala (view-change / ack / new-view) into
6-round phases, so a faulty primary rotates instead of aborting.

Digests are an int32 mixing hash of the int request (SHA-256 in the
reference).  The hash is uint32 arithmetic: torch has no uint32 multiply,
so it runs in int64 masked to 32 bits, logical shifts included, and
returns the int32 bit pattern (the ops.fused ``_u32``/``_i32`` idiom).

Decision encoding: int32, -1 = null (aborted / suspected coordinator).
The fused forms are engine.fast.run_pbft_fast and run_pbft_vc_fast.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.ops.fused import _i32, _u32
from round_tpu_torch.ops.mailbox import Mailbox, first_true
from round_tpu_torch.utils.tree import struct

DECIDE_NULL = -1


def digest(x) -> torch.Tensor:
    """Cheap int32 mixing hash standing in for SHA-256
    (round_tpu/models/pbft.py::digest): the uint32 multiply-xorshift chain,
    in int64 masked to 32 bits."""
    h = _u32(x)
    h = _u32(h * 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _u32(h * 0x85EBCA6B)
    return _i32(h ^ (h >> 13))


@struct
class BcpState:
    x: torch.Tensor         # int32 request
    dig: torch.Tensor       # int32 digest of x
    valid: torch.Tensor     # bool — x is non-null and digest-consistent
    prepared: torch.Tensor  # bool
    decided: torch.Tensor
    decision: torch.Tensor  # int32, -1 = null

    @classmethod
    def fresh(cls, x0, S: int, n: int) -> "BcpState":
        """The [S, n]-batched state PbftConsensus's init gives every lane,
        from an [n] request vector, on the device of ``x0``."""
        x0 = torch.as_tensor(x0).to(torch.int32)
        dev = x0.device
        return cls(
            x=x0.expand((S, n)).contiguous(),
            dig=digest(x0).expand((S, n)).contiguous(),
            valid=torch.ones((S, n), dtype=torch.bool, device=dev),
            prepared=torch.zeros((S, n), dtype=torch.bool, device=dev),
            decided=torch.zeros((S, n), dtype=torch.bool, device=dev),
            decision=torch.full((S, n), DECIDE_NULL, dtype=torch.int32,
                                device=dev),
        )


def _coord(ctx: RoundCtx):
    return (ctx.r // 3) % ctx.n


class BcpPrePrepare(Round):
    """round_tpu/models/pbft.py::BcpPrePrepare."""

    def send(self, ctx: RoundCtx, state: BcpState):
        return broadcast(ctx, {"req": state.x, "dig": state.dig},
                         guard=ctx.id == _coord(ctx))

    def update(self, ctx: RoundCtx, state: BcpState, mbox: Mailbox):
        coord = _coord(ctx)
        got = mbox.contains(coord)
        # the coordinator depends on the round alone, so it is not a
        # batched index: Mailbox.get gathers it on the device (a plain
        # v[coord] would read it to the host first)
        picked = mbox.get(coord)
        req, claimed = picked["req"], picked["dig"]
        recomputed = digest(req)

        is_coord = ctx.id == coord
        adopt = got & ~is_coord
        x = torch.where(adopt, req, state.x)
        dig = torch.where(adopt, recomputed, state.dig)
        valid = torch.where(adopt, recomputed == claimed, state.valid)

        # finishRound: abort on no/invalid request (Consensus.scala:90-97)
        fail = ~got | ~valid
        ctx.exit_at_end_of_round(fail)
        state = ghost_decide(state, fail,
                             torch.full_like(state.decision, DECIDE_NULL))
        return state.replace(x=x, dig=dig, valid=valid)


class BcpPrepare(Round):
    """round_tpu/models/pbft.py::BcpPrepare."""

    def send(self, ctx: RoundCtx, state: BcpState):
        return broadcast(ctx, {"dig": state.dig, "ok": state.valid})

    def update(self, ctx: RoundCtx, state: BcpState, mbox: Mailbox):
        confirmed = mbox.count(lambda m: m["ok"] & (m["dig"] == state.dig))
        return state.replace(prepared=confirmed > 2 * ctx.n // 3)


class BcpCommit(Round):
    """round_tpu/models/pbft.py::BcpCommit."""

    def send(self, ctx: RoundCtx, state: BcpState):
        return broadcast(ctx, state.dig, guard=state.prepared)

    def update(self, ctx: RoundCtx, state: BcpState, mbox: Mailbox):
        confirmed = mbox.count(lambda d: d == state.dig)
        committed = confirmed > 2 * ctx.n // 3
        every = torch.ones_like(state.decided)
        ctx.exit_at_end_of_round(every)  # terminate either way (:160)
        return ghost_decide(state, every,
                            torch.where(committed, state.x, DECIDE_NULL))


# ---------------------------------------------------------------------------
# View change (example/byzantine/pbft/ViewChange.scala — the reference ships
# only this unsigned sketch and never wires it to its consensus; round_tpu
# makes the round family executable and composes it with the decision)
# ---------------------------------------------------------------------------

def cert_digest(req, pv) -> torch.Tensor:
    """Digest of a (request, prepared-view) certificate — the
    ViewChangeAck's per-sender confirmation token (ViewChange.scala:20-22;
    round_tpu/models/pbft.py::cert_digest).  ``req·31 + pv`` wraps as
    int32 arithmetic does: digest reads it modulo 2^32."""
    return digest(_u32(req) * 31 + _u32(pv))


@struct
class PbftVcState:
    # consensus core (BcpState semantics, at the CURRENT view)
    x: torch.Tensor          # int32 request
    dig: torch.Tensor        # int32 digest of x
    valid: torch.Tensor      # bool
    prepared: torch.Tensor   # bool (this view)
    decided: torch.Tensor
    decision: torch.Tensor
    # view bookkeeping
    view: torch.Tensor       # int32 current view; coord = view % n
    next_view: torch.Tensor  # int32 target view while vc_active
    vc_active: torch.Tensor  # bool — participating in a view change
    # prepared certificate (survives across views; ViewChange.scala 𝓟)
    prep_req: torch.Tensor   # int32
    prep_view: torch.Tensor  # int32, -1 = none
    # the reference's distributedState (ViewChange.scala:73): the VC1
    # messages this lane holds, as [n] vectors
    vc_heard: torch.Tensor   # [n] bool
    vc_req: torch.Tensor     # [n] int32
    vc_pv: torch.Tensor      # [n] int32
    # VC2 outcome at the would-be new primary
    sel_req: torch.Tensor    # int32 — the new view's request
    nv_ok: torch.Tensor      # bool — confirmed-certificate quorum reached

    @classmethod
    def fresh(cls, x0, S: int, n: int) -> "PbftVcState":
        """The batched [S, n] initial state from an [n] request vector, on
        the device of ``x0`` (round_tpu/models/pbft.py::PbftVcState.fresh:
        one constructor for every caller of the fused engine)."""
        x0 = torch.as_tensor(x0).to(torch.int32)
        dev = x0.device
        i32 = torch.int32

        def full(shape, v, dtype=i32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        return cls(
            x=x0.expand((S, n)).contiguous(),
            dig=digest(x0).expand((S, n)).contiguous(),
            valid=full((S, n), True, torch.bool),
            prepared=full((S, n), False, torch.bool),
            decided=full((S, n), False, torch.bool),
            decision=full((S, n), DECIDE_NULL),
            view=full((S, n), 0),
            next_view=full((S, n), 0),
            vc_active=full((S, n), False, torch.bool),
            prep_req=full((S, n), 0),
            prep_view=full((S, n), -1),
            vc_heard=full((S, n, n), False, torch.bool),
            vc_req=full((S, n, n), 0),
            vc_pv=full((S, n, n), -1),
            sel_req=full((S, n), 0),
            nv_ok=full((S, n), False, torch.bool),
        )


def _vc_coord(state: PbftVcState, ctx: RoundCtx):
    """Primary of the CURRENT view (PBFT rotation: view mod n)."""
    return (state.view % ctx.n).to(torch.int32)


class VcPrePrepare(Round):
    """Pre-prepare at the current view; failure starts a view change
    instead of deciding null (round_tpu/models/pbft.py::VcPrePrepare)."""

    def send(self, ctx: RoundCtx, state: PbftVcState):
        return broadcast(
            ctx, {"req": state.x, "dig": state.dig, "view": state.view},
            guard=(ctx.id == _vc_coord(state, ctx)) & ~state.vc_active)

    def update(self, ctx: RoundCtx, state: PbftVcState, mbox: Mailbox):
        coord = _vc_coord(state, ctx)
        got = mbox.contains(coord) & (mbox.values["view"][coord]
                                      == state.view)
        req = mbox.values["req"][coord]
        claimed = mbox.values["dig"][coord]
        recomputed = digest(req)

        active = ~state.vc_active & ~state.decided
        is_coord = ctx.id == coord
        adopt = got & ~is_coord & active
        x = torch.where(adopt, req, state.x)
        dig = torch.where(adopt, recomputed, state.dig)
        valid = torch.where(adopt, recomputed == claimed, state.valid)

        # no/invalid request: this primary is suspect — trigger view change
        fail = active & (~got | ~valid)
        return state.replace(
            x=x, dig=dig, valid=valid,
            vc_active=state.vc_active | fail,
            next_view=torch.where(fail, state.view + 1, state.next_view),
        )


class VcPrepare(Round):
    """round_tpu/models/pbft.py::VcPrepare."""

    def send(self, ctx: RoundCtx, state: PbftVcState):
        return broadcast(
            ctx, {"dig": state.dig, "ok": state.valid, "view": state.view},
            guard=~state.vc_active)

    def update(self, ctx: RoundCtx, state: PbftVcState, mbox: Mailbox):
        confirmed = mbox.count(
            lambda m: m["ok"] & (m["dig"] == state.dig)
            & (m["view"] == state.view))
        prepared = (confirmed > 2 * ctx.n // 3) & ~state.vc_active \
            & ~state.decided
        # the prepared CERTIFICATE outlives the view (ViewChange.scala 𝓟)
        return state.replace(
            prepared=prepared,
            prep_req=torch.where(prepared, state.x, state.prep_req),
            prep_view=torch.where(prepared, state.view, state.prep_view),
        )


class VcCommit(Round):
    """round_tpu/models/pbft.py::VcCommit."""

    def send(self, ctx: RoundCtx, state: PbftVcState):
        return broadcast(ctx, {"dig": state.dig, "view": state.view},
                         guard=state.prepared & ~state.vc_active)

    def update(self, ctx: RoundCtx, state: PbftVcState, mbox: Mailbox):
        confirmed = mbox.count(
            lambda m: (m["dig"] == state.dig) & (m["view"] == state.view))
        active = ~state.vc_active & ~state.decided
        committed = (confirmed > 2 * ctx.n // 3) & active
        state = ghost_decide(state, committed, state.x)
        ctx.exit_at_end_of_round(state.decided)
        # an uncommitted phase rotates the primary (PBFT liveness), it
        # does NOT abort the instance like the reference's 3-phase test
        fail = active & ~committed
        return state.replace(
            vc_active=state.vc_active | fail,
            next_view=torch.where(fail, state.view + 1, state.next_view),
        )


class VcViewChange(Round):
    """ViewChange.scala round 1: broadcast the prepared certificate for
    next_view; every lane accumulates certificates
    (round_tpu/models/pbft.py::VcViewChange)."""

    def send(self, ctx: RoundCtx, state: PbftVcState):
        return broadcast(
            ctx, {"nv": state.next_view, "pr": state.prep_req,
                  "pv": state.prep_view},
            guard=state.vc_active)

    def update(self, ctx: RoundCtx, state: PbftVcState, mbox: Mailbox):
        match = mbox.mask & (mbox.values["nv"] == state.next_view)
        keep = state.vc_active & ~state.decided
        return state.replace(
            vc_heard=torch.where(keep, match, torch.zeros_like(
                state.vc_heard)),
            vc_req=torch.where(keep, mbox.values["pr"], state.vc_req),
            vc_pv=torch.where(keep & match, mbox.values["pv"],
                              torch.full_like(state.vc_pv, -1)),
        )


class VcViewChangeAck(Round):
    """ViewChange.scala round 2: ack the held certificates by digest; the
    new primary keeps certificates confirmed by > n/3 acks and, on a > 2n/3
    confirmed quorum, selects the max-prepared-view request
    (round_tpu/models/pbft.py::VcViewChangeAck)."""

    def send(self, ctx: RoundCtx, state: PbftVcState):
        ackd = torch.where(state.vc_heard,
                           cert_digest(state.vc_req, state.vc_pv), -1)
        return broadcast(ctx, {"nv": state.next_view, "ackd": ackd},
                         guard=state.vc_active)

    def update(self, ctx: RoundCtx, state: PbftVcState, mbox: Mailbox):
        n = ctx.n
        my_cert = cert_digest(state.vc_req, state.vc_pv)        # [n]
        acker_ok = mbox.mask & (mbox.values["nv"] == state.next_view)
        # confirm[j] = #{ ackers i : ackd[i, j] matches my cert j }
        matches = (mbox.values["ackd"] == my_cert[None, :]) \
            & acker_ok[:, None]                                  # [n, n]
        confirm = matches.to(torch.int32).sum(dim=0, dtype=torch.int32)
        confirmed = state.vc_heard & (confirm > n // 3)
        quorum = confirmed.to(torch.int32).sum(dtype=torch.int32) \
            > 2 * n // 3

        # select max prepared view among confirmed certificates; ties go
        # to the smallest sender id; no prepared certificate -> own x
        has_prep = confirmed & (state.vc_pv >= 0)
        key = torch.where(has_prep, state.vc_pv, -2)
        best = first_true(key == key.max())
        # vc_req[best] as a [1] gather: a 0-d index would read it on the host
        sel = torch.where(has_prep.any(), state.vc_req[best.reshape(1)][0],
                          state.x)

        keep = state.vc_active & ~state.decided
        return state.replace(
            sel_req=torch.where(keep, sel, state.sel_req),
            nv_ok=torch.where(keep, quorum, state.nv_ok),
        )


class VcNewView(Round):
    """ViewChange.scala round 3: the new primary broadcasts the new view;
    receivers install it and resume consensus; lanes that miss it retry at
    next_view + 1 (round_tpu/models/pbft.py::VcNewView)."""

    def send(self, ctx: RoundCtx, state: PbftVcState):
        is_new_coord = ctx.id == (state.next_view % ctx.n).to(torch.int32)
        return broadcast(
            ctx, {"nv": state.next_view, "sel": state.sel_req},
            guard=state.vc_active & is_new_coord & state.nv_ok)

    def update(self, ctx: RoundCtx, state: PbftVcState, mbox: Mailbox):
        nc = (state.next_view % ctx.n).to(torch.int32)
        got = mbox.contains(nc) & (mbox.values["nv"][nc] == state.next_view)
        sel = mbox.values["sel"][nc]

        keep = state.vc_active & ~state.decided
        install = keep & got
        retry = keep & ~got
        return state.replace(
            view=torch.where(install, state.next_view, state.view),
            x=torch.where(install, sel, state.x),
            dig=torch.where(install, digest(sel), state.dig),
            valid=torch.where(install, True, state.valid),
            prepared=torch.where(install, False, state.prepared),
            vc_active=torch.where(install, False, state.vc_active),
            next_view=torch.where(retry, state.next_view + 1,
                                  state.next_view),
        )


class PbftViewChange(Algorithm):
    """PBFT consensus WITH primary rotation: 6-round phases — pre-prepare /
    prepare / commit (failure starts a view change instead of deciding
    null), then view-change / ack / new-view.  Decides through a faulty
    primary; f < n/3 (round_tpu/models/pbft.py::PbftViewChange)."""

    fault_envelope = "n > 3f"
    adversary_model = "byzantine"
    decision_null = DECIDE_NULL

    def __init__(self):
        self.rounds = (
            VcPrePrepare(), VcPrepare(), VcCommit(),
            VcViewChange(), VcViewChangeAck(), VcNewView(),
        )

    def make_init_state(self, ctx: RoundCtx, io) -> PbftVcState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        n, dev = ctx.n, x.device

        def full(shape, v, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        return PbftVcState(
            x=x, dig=digest(x), valid=full((), True, torch.bool),
            prepared=full((), False, torch.bool),
            decided=full((), False, torch.bool),
            decision=full((), DECIDE_NULL), view=full((), 0),
            next_view=full((), 0), vc_active=full((), False, torch.bool),
            prep_req=full((), 0), prep_view=full((), -1),
            vc_heard=full((n,), False, torch.bool), vc_req=full((n,), 0),
            vc_pv=full((n,), -1), sel_req=full((), 0),
            nv_ok=full((), False, torch.bool),
        )

    def decided(self, state: PbftVcState):
        return state.decided

    def decision(self, state: PbftVcState):
        return state.decision


class PbftConsensus(Algorithm):
    """Single-decision PBFT-style consensus, f < n/3 byzantine
    (round_tpu/models/pbft.py::PbftConsensus).  ``synchronized`` wraps
    each round in utils.byzantine.SynchronizedRound."""

    fault_envelope = "n > 3f"
    adversary_model = "byzantine"
    decision_null = DECIDE_NULL

    def __init__(self, synchronized: bool = False):
        rounds = (BcpPrePrepare(), BcpPrepare(), BcpCommit())
        if synchronized:
            from round_tpu_torch.utils.byzantine import synchronize

            rounds = synchronize(rounds)
        self.rounds = rounds

    def make_init_state(self, ctx: RoundCtx, io) -> BcpState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        false = torch.zeros((), dtype=torch.bool, device=x.device)
        return BcpState(
            x=x, dig=digest(x), valid=~false, prepared=false, decided=false,
            decision=torch.full((), DECIDE_NULL, dtype=torch.int32,
                                device=x.device),
        )

    def decided(self, state: BcpState):
        return state.decided

    def decision(self, state: BcpState):
        return state.decision
