"""The Round DSL: how users express one communication-closed round.

Port of round_tpu/core/rounds.py.  A round is a pair of *pure, per-lane*
functions over the process state:

  - ``send(ctx, state) -> SendSpec``: what this process sends and to whom.
  - ``update(ctx, state, mailbox) -> state``: fold the received messages into
    the local state.  Termination is signalled with ``ctx.exit_at_end_of_round()``.

The engine batches these over the process axis with ``torch.func.vmap``, so
user code reads like the reference's per-process DSL (one process's view of
one round).  ``EventRound`` is not ported yet (no model on the ported path
needs it).

Reference parity: psync Round.scala:18-71, Round.scala:102-104.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree

from round_tpu_torch.core.progress import Progress


class RoundCtx:
    """Per-lane execution context handed to ``send``/``update``/``init``.

    Attributes:
      id:  this process's id (an int32 scalar tensor; one vmap lane per process).
      n:   group size (Python int for a fixed group).
      r:   current round number (int32 scalar tensor, wrap-around Time).
      rng: a uint32 hash word unique to (scenario, process, round), held in
           an int64 tensor — the port's stand-in for a per-lane PRNG key.
    """

    def __init__(self, id, n, r, rng=None):  # noqa: A002 - mirrors reference naming
        self.id = id
        self.n = n
        self.r = r
        self.rng = rng
        self._exit_acc = None  # None means "never signalled"

    @property
    def _exit(self):
        if self._exit_acc is None:
            return torch.zeros_like(torch.as_tensor(self.id), dtype=torch.bool)
        return self._exit_acc

    def exit_at_end_of_round(self, when=True):
        """Terminate this process's instance after the current round.

        ``when`` may be a boolean tensor (data-dependent exit becomes a lane
        mask, not control flow).  Mirrors Round.scala:42-44.
        """
        when = torch.as_tensor(when)
        self._exit_acc = (
            when if self._exit_acc is None
            else torch.logical_or(self._exit_acc, when)
        )


class SendSpec:
    """What one process emits in a round: one payload + a destination mask.

    ``payload`` is a pytree of tensors (this lane's message value — the same
    value goes to every selected destination).  ``dest_mask`` is a ``[n]``
    bool vector: dest_mask[d] == this process sends to d this round.
    """

    def __init__(self, payload: Any, dest_mask: torch.Tensor):
        self.payload = payload
        self.dest_mask = dest_mask


pytree.register_pytree_node(
    SendSpec,
    lambda spec: ([spec.payload, spec.dest_mask], None),
    lambda children, _ctx: SendSpec(*children),
    serialized_type_name="round_tpu_torch.core.rounds.SendSpec",
)


def _lane_device(ctx: RoundCtx):
    return torch.as_tensor(ctx.id).device


def broadcast(ctx: RoundCtx, payload: Any, guard=True) -> SendSpec:
    """Send ``payload`` to everyone (including self).  Round.scala:102-104."""
    g = torch.as_tensor(guard, device=_lane_device(ctx))
    return SendSpec(payload, g.expand((ctx.n,)))


def unicast(ctx: RoundCtx, dest, payload: Any, guard=True) -> SendSpec:
    """Send ``payload`` to the single process ``dest`` (e.g. the coordinator)."""
    dev = _lane_device(ctx)
    mask = (torch.arange(ctx.n, device=dev) == dest) & torch.as_tensor(
        guard, device=dev)
    return SendSpec(payload, mask)


def silence(ctx: RoundCtx, payload_like: Any) -> SendSpec:
    """Send nothing.  A payload of the round's type is still required so every
    lane produces identically-shaped tensors."""
    return SendSpec(payload_like,
                    torch.zeros((ctx.n,), dtype=torch.bool,
                                device=_lane_device(ctx)))


class Round:
    """One communication-closed round.  Subclass and implement send/update.

    Class attributes:
      init_progress: the round's progress policy (Progress); kept for API
        parity with Round.scala:25.
    """

    init_progress: Progress = Progress.timeout(10)

    def pre(self, ctx: RoundCtx, state):
        """Per-lane hook run at round start, before send — the EventRound
        ``init`` slot (Round.scala:93-97).  Default: no-op."""
        return state

    def send(self, ctx: RoundCtx, state) -> SendSpec:
        raise NotImplementedError

    def update(self, ctx: RoundCtx, state, mailbox):
        raise NotImplementedError

    def expected_nbr_messages(self, ctx: RoundCtx, state):
        """Early-exit hint (Round.scala:33-35); the lockstep engine does not
        need it."""
        return ctx.n


class FoldRound(Round):
    """Vectorized event round: the per-message ``receive`` fold expressed as
    a monoid, reduced in O(log n) vector steps (round_tpu/core/rounds.py::
    FoldRound).

    Subclasses implement:
      pre(ctx, state) -> state                  (init: reset round vars)
      send(ctx, state) -> SendSpec
      zero(ctx, state) -> m                     (monoid identity)
      lift(ctx, state, sender, payload) -> m    (one message's contribution;
                                                 vectorized over senders)
      combine(m1, m2) -> m                      (associative; elementwise torch)
      post(ctx, state, m, count, did_timeout) -> state

    ``did_timeout`` is ``not go_ahead(ctx, state, m, count)`` (default: any
    message).  The fold consumes every present message in sender-id order.
    """

    def zero(self, ctx: RoundCtx, state):
        raise NotImplementedError

    def lift(self, ctx: RoundCtx, state, sender, payload):
        raise NotImplementedError

    def combine(self, m1, m2):
        raise NotImplementedError

    def reduce(self, ctx: RoundCtx, state, lifted, mask):
        """Optional vectorized-reduction equivalent of the pairwise fold;
        default None (no declared reduction form)."""
        return None

    def go_ahead(self, ctx: RoundCtx, state, m, count):
        return count > 0

    def post(self, ctx: RoundCtx, state, m, count, did_timeout):
        return state

    def update(self, ctx: RoundCtx, state, mailbox):
        m, count = self.fold(ctx, state, mailbox)
        go = self.go_ahead(ctx, state, m, count)
        return self.post(ctx, state, m, count, torch.logical_not(go))

    def _lifted(self, ctx, state, mailbox):
        return torch.func.vmap(lambda i, p: self.lift(ctx, state, i, p))(
            mailbox.senders, mailbox.values)

    def fold_reduced(self, ctx: RoundCtx, state, mailbox):
        """(m, count) via the round's declared `reduce`; falls back to the
        tree fold when none is declared."""
        if type(self).reduce is FoldRound.reduce:
            return self.fold(ctx, state, mailbox)
        m = self.reduce(ctx, state, self._lifted(ctx, state, mailbox),
                        mailbox.mask)
        if m is None:
            return self.fold(ctx, state, mailbox)
        return m, mailbox.size()

    def fold(self, ctx: RoundCtx, state, mailbox):
        """The masked O(log n) reduction alone: (m, count)."""
        from round_tpu_torch.utils.tree import tree_where  # local: avoid cycle

        n = mailbox.n
        lifted = self._lifted(ctx, state, mailbox)
        z = self.zero(ctx, state)
        zeros = pytree.tree_map(
            lambda zl, l: torch.as_tensor(zl, dtype=l.dtype,
                                          device=l.device).expand(l.shape),
            z, lifted,
        )
        elems = tree_where(mailbox.mask, lifted, zeros)
        # pad to a power of two with identities, then halve log2(n) times
        size = 1
        while size < n:
            size *= 2
        if size != n:
            pad = pytree.tree_map(
                lambda x: x[:1].expand((size - n,) + tuple(x.shape[1:])),
                zeros,
            )
            elems = pytree.tree_map(
                lambda a, b: torch.cat([a, b], dim=0), elems, pad)
        while size > 1:
            # pair ADJACENT elements (even with odd) so the reduction is a
            # left-to-right associative grouping — sender-id fold order is
            # preserved for any associative combine, commutative or not
            left = pytree.tree_map(lambda x: x[0:size:2], elems)
            right = pytree.tree_map(lambda x: x[1:size:2], elems)
            elems = self.combine(left, right)
            size = size // 2
        m = pytree.tree_map(lambda x: x[0], elems)
        return m, mailbox.size()
