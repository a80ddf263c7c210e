"""LastVoting with event rounds — the open-round (OOPSLA'20) variant.

Port of round_tpu/models/lastvoting_event.py.  Protocol (example/
LastVotingEvent.scala:25-201): the 4-round Paxos-as-HO phase of the closed
LastVoting, expressed with per-message receive handlers and fine-grained
Progress control:

  round 1 (collect): processes send (x, ts) to coord; coord folds a running
    max-timestamp (``payload._2 >= maxTime`` — the LAST arrival wins ties,
    :77-81) seeded with its OWN x (init: maxVal = x, :58), commits when it
    heard a majority — except in the very first round, where it goAheads
    immediately and proposes its own value (:60-62).
  round 2 (propose): committed coord broadcasts vote; receivers adopt
    x := payload, ts := phase (:112-116).
  round 3 (ack): adopters send x to coord; coord is ready on a majority
    (:146-155).
  round 4 (decide): ready coord broadcasts vote; receivers decide, reset
    ready/commit, and exit once decided (:184-193).

Each receive fold is a ``FoldRound`` (core/rounds.py): a masked O(log n)
tree reduction in sender-id order, so the ``>=`` running max lowers to a
lexicographic (ts, sender_id) maximum — bit-identical to the sequential
``EventRound`` fold at any n.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import FoldRound, RoundCtx, broadcast, unicast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.models.lastvoting import LVSpec, LVState


def _coord(ctx: RoundCtx):
    return (ctx.r // 4) % ctx.n


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=like.device)


class LVECollect(FoldRound):
    """Round 1: (x, ts) to coord; running (ts, sender)-lex max; commit
    (round_tpu/models/lastvoting_event.py::LVECollect)."""

    def send(self, ctx: RoundCtx, state: LVState):
        # r == 0: nothing is sent (LastVotingEvent.scala:68-73)
        return unicast(ctx, _coord(ctx), {"x": state.x, "ts": state.ts},
                       guard=ctx.r != 0)

    def zero(self, ctx: RoundCtx, state: LVState):
        # the coord's own x seeds the running max with ts = -1 and a sender
        # id below every real one, so any message with ts >= -1 replaces it
        # — the `>=` semantics (:58, :77-81)
        return {"ts": _i32(-1, state.ts), "id": _i32(-1, state.ts),
                "x": state.x}

    def lift(self, ctx: RoundCtx, state: LVState, sender, payload):
        return {"ts": payload["ts"], "id": sender.to(torch.int32),
                "x": payload["x"]}

    def combine(self, a, b):
        b_wins = (b["ts"] > a["ts"]) | ((b["ts"] == a["ts"])
                                        & (b["id"] >= a["id"]))

        def pick(x, y):
            return torch.where(b_wins, y, x)

        return {"ts": pick(a["ts"], b["ts"]), "id": pick(a["id"], b["id"]),
                "x": pick(a["x"], b["x"])}

    def reduce(self, ctx: RoundCtx, state: LVState, lifted, mask):
        # the `>=`-running lex (ts, id) max as reductions: the max timestamp
        # over present senders (the zero carries ts = -1 too), then the
        # highest-id sender at that timestamp (ids are distinct, so the max
        # IS the last-wins tie-break)
        m_ts = torch.where(mask, lifted["ts"], -1).max()
        at_max = mask & (lifted["ts"] == m_ts)
        ids = torch.where(at_max, torch.arange(mask.shape[0],
                                               device=mask.device), -1)
        m_id = ids.max()
        # the at-max sender's slot as round_tpu takes it (argmax over the
        # masked ids, the index of m_id whenever m_id >= 0), gathered as a
        # [1] index so that an unbatched trace reads nothing on the host;
        # verify/extract.py reads this as round_tpu's argmax site
        idx = torch.argmax(ids)
        m_x = torch.where(m_id >= 0, lifted["x"][idx.reshape(1)][0], state.x)
        return {"ts": m_ts, "id": m_id.to(torch.int32), "x": m_x}

    def go_ahead(self, ctx: RoundCtx, state: LVState, m, count):
        # init: r == 0 or non-coord goAhead immediately; coord otherwise
        # needs a majority (:60-64, :82-83)
        return (ctx.r == 0) | (ctx.id != _coord(ctx)) | (count > ctx.n // 2)

    def post(self, ctx: RoundCtx, state: LVState, m, count, did_timeout):
        act = (ctx.id == _coord(ctx)) & ~did_timeout
        return state.replace(
            commit=state.commit | act,
            vote=torch.where(act, m["x"], state.vote),
        )


class _CoordMessage(FoldRound):
    """Shared monoid for rounds that only consume the coordinator's
    broadcast: keep the payload that came from coord."""

    def zero(self, ctx: RoundCtx, state: LVState):
        return {"got": torch.zeros((), dtype=torch.bool,
                                   device=state.x.device),
                "v": _i32(0, state.x)}

    def lift(self, ctx: RoundCtx, state: LVState, sender, payload):
        from_coord = sender == _coord(ctx)
        return {"got": from_coord,
                "v": torch.where(from_coord, payload, 0).to(torch.int32)}

    def combine(self, a, b):
        return {"got": a["got"] | b["got"],
                "v": torch.where(b["got"], b["v"], a["v"])}


class LVEPropose(_CoordMessage):
    """Round 2: committed coord broadcasts vote; receivers adopt
    (round_tpu/models/lastvoting_event.py::LVEPropose)."""

    def send(self, ctx: RoundCtx, state: LVState):
        return broadcast(ctx, state.vote,
                         guard=(ctx.id == _coord(ctx)) & state.commit)

    def go_ahead(self, ctx: RoundCtx, state: LVState, m, count):
        # non-committed coord goAheads immediately (:99-101); receivers
        # goAhead on the coord's message (:117)
        return m["got"] | ((ctx.id == _coord(ctx)) & ~state.commit)

    def post(self, ctx: RoundCtx, state: LVState, m, count, did_timeout):
        return state.replace(
            x=torch.where(m["got"], m["v"], state.x),
            ts=torch.where(m["got"], ctx.r // 4, state.ts),
        )


class LVEAck(FoldRound):
    """Round 3: adopters ack; coord ready on majority
    (round_tpu/models/lastvoting_event.py::LVEAck)."""

    def send(self, ctx: RoundCtx, state: LVState):
        return unicast(ctx, _coord(ctx), state.x,
                       guard=state.ts == ctx.r // 4)

    def zero(self, ctx: RoundCtx, state: LVState):
        return _i32(0, state.x)

    def lift(self, ctx: RoundCtx, state: LVState, sender, payload):
        return torch.ones_like(payload, dtype=torch.int32)

    def combine(self, a, b):
        return a + b

    def go_ahead(self, ctx: RoundCtx, state: LVState, m, count):
        return (ctx.id != _coord(ctx)) | (count > ctx.n // 2)

    def post(self, ctx: RoundCtx, state: LVState, m, count, did_timeout):
        # ready = (!didTimeout && id == coord)  (:153-155)
        return state.replace(ready=(ctx.id == _coord(ctx)) & ~did_timeout)


class LVEDecide(_CoordMessage):
    """Round 4: ready coord broadcasts vote; receivers decide and exit
    (round_tpu/models/lastvoting_event.py::LVEDecide)."""

    def send(self, ctx: RoundCtx, state: LVState):
        return broadcast(ctx, state.vote,
                         guard=(ctx.id == _coord(ctx)) & state.ready)

    def go_ahead(self, ctx: RoundCtx, state: LVState, m, count):
        return m["got"] | ((ctx.id == _coord(ctx)) & ~state.ready)

    def post(self, ctx: RoundCtx, state: LVState, m, count, did_timeout):
        state = ghost_decide(state, m["got"], m["v"])
        ctx.exit_at_end_of_round(state.decided)
        no = torch.zeros_like(state.ready)
        return state.replace(ready=no, commit=no)


class LastVotingEvent(Algorithm):
    """Event-round LastVoting (LastVotingEvent.scala:25-201;
    round_tpu/models/lastvoting_event.py::LastVotingEvent)."""

    def __init__(self):
        self.rounds = (LVECollect(), LVEPropose(), LVEAck(), LVEDecide())
        self.spec = LVSpec()

    def make_init_state(self, ctx: RoundCtx, io) -> LVState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return LVState(
            x=x,
            ts=zero - 1,
            ready=zero != 0,
            commit=zero != 0,
            vote=zero,
            decided=zero != 0,
            decision=zero - 1,
        )

    def decided(self, state: LVState):
        return state.decided

    def decision(self, state: LVState):
        return state.decision
