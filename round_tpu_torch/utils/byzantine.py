"""Byzantine-tolerant round synchronization (f < n/3), and payload
corruption by byzantine senders.

Port of round_tpu/utils/byzantine.py.  The reference's PessimisticByzantineSynchronizer
(utils/PessimisticByzantineSynchronizer.scala:16-67) wraps a round so that
it ALWAYS broadcasts — None where the inner round had nothing to send — so
every correct process receives n-f countable messages per round.  In the
lockstep engine that is `SynchronizedRound`: every lane broadcasts
(payload, dest-row) and the inner round's mailbox is rebuilt from the
receiver's column of the dest rows.  The timing side (count n-f before
progressing) is the HO family ``scenarios.sync_k_filter(base, n - f)``.

Payload corruption by byzantine senders is a separate adversary transform
(``corrupt_payloads``, composed with the engine by ``AdversarialRound``),
mirroring the runtime's tolerance of garbage messages
(InstanceHandler.scala:392-399): correctness must come from the
algorithm's quorums, never from trusting a payload.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from round_tpu_torch.core.rounds import Round, RoundCtx, SendSpec
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import tree_leaves, tree_map


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


def round_key(key, r) -> torch.Tensor:
    """The per-round garbage key: the link hash of (key, round r) at links
    0 and 1, a length-2 uint32 key (int64) that ``scenarios._key_salt``
    reads like any other."""
    from round_tpu_torch.byz.adversary import _link_u32
    from round_tpu_torch.engine.scenarios import _key_salt

    k0, k1 = _key_salt(key)
    r = torch.as_tensor(r)
    return _link_u32(k0, k1, r, 2, 0, r.device).reshape(-1)[:2]


def corrupt_payloads(
    payload_fn: Callable[[Any, torch.Tensor], torch.Tensor], f: int
) -> Callable:
    """Build an adversary transform: (base_key, round_key, payload_tree, n)
    -> payload_tree with the f byzantine lanes' payloads replaced by
    ``payload_fn(round_key, original)`` (round_tpu/utils/byzantine.py::
    corrupt_payloads).  Compose with the engine via AdversarialRound.

    The byzantine set is the one ``scenarios.byzantine_silence`` draws
    for the same key (the f lowest hash ranks under its stream), so the
    mask adversary and the payload adversary pick the same lanes.  round_tpu
    draws it with a threefry permutation; the port keeps the invariant,
    not those bits.  The set is round-invariant; only the garbage varies
    with the round, through ``round_key``."""
    from round_tpu_torch.engine.scenarios import _BYZ_STREAM, _hash_crash_set

    def transform(base_key, rkey, payload, n):
        dev = tree_leaves(payload)[0].device
        byz = _hash_crash_set(base_key, n, f, dev, stream=_BYZ_STREAM)

        def corrupt_leaf(leaf):
            garbage = payload_fn(rkey, leaf)
            mask = byz.reshape((n,) + (1,) * (leaf.dim() - 1))
            return torch.where(mask, garbage, leaf)

        return tree_map(corrupt_leaf, payload)

    return transform


class AdversarialRound(Round):
    """Apply a payload-corruption transform to what byzantine lanes send
    (round_tpu/utils/byzantine.py::AdversarialRound).

    The transform runs receiver-side on the shared payload tensor:
    corrupting the sender's slot corrupts what everyone hears (per-receiver
    equivocation is the value adversary of byz/adversary.py)."""

    def __init__(self, inner: Round, transform, key):
        self.inner = inner
        self.transform = transform
        self.key = key

    def pre(self, ctx: RoundCtx, state):
        return self.inner.pre(ctx, state)

    def send(self, ctx: RoundCtx, state) -> SendSpec:
        return self.inner.send(ctx, state)

    def update(self, ctx: RoundCtx, state, mbox: Mailbox):
        rk = round_key(self.key, ctx.r)
        values = self.transform(self.key, rk, mbox.values, ctx.n)
        return self.inner.update(ctx, state, Mailbox(values, mbox.mask))
