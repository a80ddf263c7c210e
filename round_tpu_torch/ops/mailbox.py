"""Mailbox: one receiver's view of a round's messages, as masked tensors.

Port of round_tpu/ops/mailbox.py.  The mailbox is a *view*: the shared
``[n]`` payload tensor(s) of all senders plus a ``[n]`` bool presence mask
(this receiver's row of the delivery matrix).  Every Map operation used by
the reference examples has a masked-reduction counterpart:

    Map op (reference example)               Mailbox op
    ------------------------------------     -------------------------
    mailbox.size           (Otr.scala:64)    size()
    mailbox.count(pred)    (Otr.scala:67)    count(pred)
    mailbox contains p     (LastVoting:153)  contains(p)
    mailbox(p)             (LastVoting:154)  get(p)
    mmor / groupBy+minBy   (Otr.scala:44)    min_most_often_received()
    maxBy(key)             (LastVoting:132)  arg_best(key) / best_by(key)
    foldLeft min           (FloodMin:26)     fold_min(init)
    values.max/min         (Epsilon)         masked_max()/masked_min()
    head (any element)     (TPC:72)          any_value()

All ops are deterministic: ties break toward the smallest sender id.
"First index where a mask holds" is ``torch.argmax`` of the 0/1 mask,
which returns the first maximal index (as ``jnp.argmax`` does); that one
body runs in the engine and is the boolean argmax site that
verify/extract.py reads.
Counts are exact integer sums (int32), not float matmuls.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

_INT_MIN = -(2**31)
_INT_MAX = 2**31 - 1


def _pick(v: torch.Tensor, idx):
    """``v[idx]`` along the sender axis.  A 0-d index tensor is gathered as
    a [1] index on the device: indexing with it directly reads it to the
    host first, a sync per call on the card."""
    if isinstance(idx, torch.Tensor) and idx.dim() == 0:
        return v[idx.reshape(1)][0]
    return v[idx]


def _tree_pick(values: Any, idx):
    return pytree.tree_map(lambda v: _pick(v, idx), values)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis of a bool mask (0 where
    none, like jnp.argmax over an all-False mask)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


class Mailbox:
    """One receiver's mailbox for one round.

    Attributes:
      values: pytree of tensors with leading sender axis ``[n, ...]`` — the
        payloads of *all* lanes (shared across receivers).
      mask: ``[n]`` bool — mask[i] is True iff this receiver heard from i.
    """

    def __init__(self, values: Any, mask: torch.Tensor):
        self.values = values
        self.mask = mask

    @property
    def n(self) -> int:
        return self.mask.shape[0]

    @property
    def senders(self) -> torch.Tensor:
        return torch.arange(self.n, device=self.mask.device)

    # -- cardinalities -----------------------------------------------------

    def size(self) -> torch.Tensor:
        """Number of messages received (``mailbox.size``)."""
        return self.mask.to(torch.int32).sum(dtype=torch.int32)

    def count(self, pred: Callable[[Any], torch.Tensor]) -> torch.Tensor:
        """``mailbox.count{ case (k, v) => pred(v) }``; pred is vectorized over
        the sender axis."""
        return (pred(self.values) & self.mask).to(torch.int32).sum(
            dtype=torch.int32)

    def exists(self, pred: Callable[[Any], torch.Tensor]) -> torch.Tensor:
        return (pred(self.values) & self.mask).any()

    def forall(self, pred: Callable[[Any], torch.Tensor]) -> torch.Tensor:
        return torch.where(self.mask, pred(self.values), True).all()

    # -- point lookups -----------------------------------------------------

    def contains(self, pid) -> torch.Tensor:
        """``mailbox contains pid``."""
        return _pick(self.mask, pid)

    def get(self, pid) -> Any:
        """``mailbox(pid)`` — caller guards with ``contains``."""
        return _tree_pick(self.values, pid)

    def get_or(self, pid, default: Any) -> Any:
        present = _pick(self.mask, pid)
        got = _tree_pick(self.values, pid)
        return pytree.tree_map(
            lambda g, d: torch.where(present, g, d), got, default)

    # -- selection ---------------------------------------------------------

    def arg_best(self, key: torch.Tensor) -> torch.Tensor:
        """Index of the present sender maximizing ``key`` (ties -> smallest
        sender id).  ``key`` is ``[n]``, already computed from values."""
        key = torch.where(self.mask, key, _INT_MIN)
        best = key.max()
        return first_true(self.mask & (key == best))

    def best_by(self, key: torch.Tensor) -> Any:
        """Payload of ``arg_best(key)`` (``mailbox.maxBy(key)``)."""
        return _tree_pick(self.values, self.arg_best(key))

    def any_value(self) -> Any:
        """Payload of the smallest present sender (``mailbox.head`` refined)."""
        return _tree_pick(self.values, first_true(self.mask))

    # -- aggregate reductions ---------------------------------------------

    def fold_min(self, init, values=None) -> torch.Tensor:
        """``mailbox.foldLeft(init)(min)`` (FloodMin.scala:26)."""
        vals = self.values if values is None else values
        init = torch.as_tensor(init, dtype=vals.dtype, device=vals.device)
        return torch.minimum(init, torch.where(self.mask, vals, init).min())

    def masked_min(self, values=None, empty=_INT_MAX) -> torch.Tensor:
        vals = self.values if values is None else values
        return torch.where(self.mask, vals, empty).min()

    def masked_max(self, values=None, empty=_INT_MIN) -> torch.Tensor:
        vals = self.values if values is None else values
        return torch.where(self.mask, vals, empty).max()

    def masked_sum(self, values=None) -> torch.Tensor:
        vals = self.values if values is None else values
        return torch.where(self.mask, vals, 0).sum(dtype=vals.dtype)

    def value_histogram(self, num_values: int, values=None) -> torch.Tensor:
        """``counts[v] = #{ present senders with value == v }`` for a payload
        whose value domain is the static range ``[0, num_values)`` — an
        exact int32 count."""
        vals = self.values if values is None else values
        onehot = vals[:, None] == torch.arange(
            num_values, dtype=vals.dtype, device=vals.device)[None, :]
        return (onehot & self.mask[:, None]).to(torch.int32).sum(
            dim=0, dtype=torch.int32)

    def min_most_often_received(self, values=None,
                                num_values: int | None = None) -> torch.Tensor:
        """OTR's ``mmor`` (Otr.scala:44-49): the value received most often;
        ties broken toward the smallest value.  Assumes at least one message
        (guarded by the caller's quorum check, as in the reference).

        count[i] = #{ j present : v_j == v_i }, take max count, then min value
        among slots achieving it.  With ``num_values`` the count runs over
        the [0, num_values) histogram and the answer is the smallest value
        with the largest count."""
        vals = self.values if values is None else values
        if num_values is not None:
            counts = self.value_histogram(num_values, vals)
            return first_true(counts == counts.max()).to(vals.dtype)
        # counts[c] = Σ_i mask[i] ∧ (v_c == v_i), summed over the sender
        # axis 0 as round_tpu's mask @ eq contracts it, so the extracted
        # formula (verify/extract.py) is round_tpu's term for term
        eq = vals[None, :] == vals[:, None]
        counts = (self.mask[:, None] & eq).to(torch.int32).sum(
            dim=0, dtype=torch.int32)
        max_count = counts.max()
        # a slot ties the max only if its value is held by max_count present
        # senders; picking a non-present slot with that value is harmless.
        return torch.where(counts == max_count, vals, _INT_MAX).min()

    def sorted_values(self, values=None, fill=_INT_MAX):
        """Present values sorted ascending, absent slots pushed to the end as
        ``fill``; returns (sorted [n], count)."""
        vals = self.values if values is None else values
        filled = torch.where(self.mask, vals, fill)
        return torch.sort(filled).values, self.size()
