"""Byzantine-tolerant round synchronization (f < n/3): the message side.

Port of the ``SynchronizedRound`` / ``synchronize`` part of
round_tpu/utils/byzantine.py (the payload adversaries are a later slice).
The reference's PessimisticByzantineSynchronizer
(utils/PessimisticByzantineSynchronizer.scala:16-67) wraps a round so that
it ALWAYS broadcasts — None where the inner round had nothing to send — so
every correct process receives n-f countable messages per round.  In the
lockstep engine that is `SynchronizedRound`: every lane broadcasts
(payload, dest-row) and the inner round's mailbox is rebuilt from the
receiver's column of the dest rows.  The timing side (count n-f before
progressing) is the HO family ``scenarios.sync_k_filter(base, n - f)``.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.rounds import Round, RoundCtx, SendSpec
from round_tpu_torch.ops.mailbox import Mailbox


class SynchronizedRound(Round):
    """Wrap a Round so every lane always broadcasts (None-padded payloads;
    round_tpu/utils/byzantine.py::SynchronizedRound).

    The wire payload is {"value": inner payload, "dest_row": the inner
    dest mask}; each receiver reads its own column of the dest rows —
    semantically identical to Some/None padding per destination."""

    def __init__(self, inner: Round):
        self.inner = inner

    def pre(self, ctx: RoundCtx, state):
        return self.inner.pre(ctx, state)

    def send(self, ctx: RoundCtx, state) -> SendSpec:
        spec = self.inner.send(ctx, state)
        wrapped = {"value": spec.payload, "dest_row": spec.dest_mask}
        return SendSpec(wrapped, torch.ones((ctx.n,), dtype=torch.bool,
                                            device=spec.dest_mask.device))

    def update(self, ctx: RoundCtx, state, mbox: Mailbox):
        defined = mbox.values["dest_row"][:, ctx.id]
        inner_mbox = Mailbox(mbox.values["value"], mbox.mask & defined)
        return self.inner.update(ctx, state, inner_mbox)


def synchronize(rounds) -> tuple:
    """Wrap every round of a phase (the wrapRound helper of
    byzantine/test/Consensus.scala:48-54;
    round_tpu/utils/byzantine.py::synchronize)."""
    return tuple(SynchronizedRound(r) for r in rounds)
