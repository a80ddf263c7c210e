"""The value-adversary fault model as tensors, and the engine hook.

Port of round_tpu/byz/adversary.py.  Omission families answer "which links
deliver"; the value adversary answers "what a delivered frame claims".
Three primitives:

  * ``value_events``: the one counter-hash formula deciding, per (round,
    src, dst), whether a byzantine-value sender substitutes its payload
    toward that destination and with which claimed value.  Same murmur3
    link hash as every other family under dedicated streams, so one
    (salt0, salt1) pair gives schedules independent of the omission
    families.  Leading batch dims of the genome leaves broadcast, so one
    call draws a whole population's ``[P, n, n]`` events.
  * ``value_plan``: the explicit ``[T, n, n] int32`` substitution plan
    (``plan[r, dst, src]``): ``VP_NONE`` = truthful, ``VP_STALE`` = replay
    the sender's previous transmission of this round class, ``v >= 0`` =
    claim value ``v``.  Bit-identical to what the hash formula draws.
  * ``ValueAdversary``: the engine hook.  ``executor.run_round`` hands it
    the round's truthful payload tree and gets the per-receiver mailbox
    values back; stale replay carries each round class's last sent payload
    (``prev``), and a class never sent yet replays nothing.

Hash arithmetic is uint32 held in int64 and masked to 32 bits after every
product and sum (``ops.fused._u32``/``_fmix32``): salts are int32 bit
patterns, often negative.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from round_tpu_torch.byz.lies import LieFn, generic_lie
from round_tpu_torch.engine.scenarios import LINK_GOLD, LINK_RMIX
from round_tpu_torch.ops.fused import _fmix32, _u32
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import tree_leaves, tree_map, tree_where

# Value-adversary stream constants: per-(round, link) draws from the one
# counter-based link hash, disjoint from the omission/silence/wire streams
STREAM_BYZ_VAL = 0xA53F9C71    # substitute? draws (per round, link)
STREAM_BYZ_STALE = 0xC3D21B85  # stale-replay draws
STREAM_BYZ_FACE = 0xD7E84A2D   # which face (vA/vB) each link hears

# explicit-plan opcodes (plan[r, dst, src])
VP_NONE = -1   # truthful delivery
VP_STALE = -2  # replay the sender's previous send of this round class

_M32 = 0xFFFFFFFF


def _dev_of(*xs, device=None) -> torch.device:
    """The device of the first tensor among ``xs``, else ``device``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _word(x, dev) -> torch.Tensor:
    """uint32 value of an int, int32 bit pattern or tensor, as int64 on
    ``dev``.  A Python int is filled on the device: a host-to-device copy
    would wait for it."""
    if isinstance(x, torch.Tensor):
        return _u32(x.to(dev))
    if isinstance(x, np.ndarray) and x.ndim:
        return _u32(torch.as_tensor(x, device=dev))
    return torch.full((), int(x) & _M32, dtype=torch.int64, device=dev)


def _link_u32(salt0, salt1, r, n: int, stream: int,
              device=None) -> torch.Tensor:
    """``[.., n(recv), n(send)]`` uint32 words (int64) of the counter link
    hash at round ``r`` under ``stream`` (round_tpu/byz/adversary.py::
    _link_u32).  Leading dims of the salts and of ``r`` broadcast."""
    dev = _dev_of(salt0, salt1, r, device=device)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    idx = i[:, None] * n + i[None, :]
    s0 = _word(salt0, dev)[..., None, None]
    s1 = _word(salt1, dev)[..., None, None]
    rr = _word(r, dev)[..., None, None]
    z = (idx * LINK_GOLD + s0) & _M32
    z = z ^ ((rr * LINK_RMIX + s1 + stream) & _M32)
    return _fmix32(z)


def lie_pair(salt0, salt1, num_values: int,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The genome's two-faced lie palette ``(vA, vB)``, int32, one pair per
    (salt0, salt1) (round_tpu/byz/adversary.py::lie_pair).  A hash-mode
    adversary only ever claims one of these two: side A hears vA, side B
    hears vB, and a face stays consistent across a phase's rounds so a
    forged quorum certificate can assemble."""
    dev = _dev_of(salt0, salt1, device=device)
    m = max(1, num_values)
    a = _fmix32(_word(salt0, dev) ^ STREAM_BYZ_VAL)
    b = _fmix32((_word(salt1, dev) + STREAM_BYZ_VAL) & _M32)
    return (a % m).to(torch.int32), (b % m).to(torch.int32)


def value_events(byz_value, equiv_p8, stale_p8, salt0, salt1, r, n: int,
                 num_values: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round-r value-fault draws ``(sub_v, stale)``: ``sub_v [..,
    n(recv), n(send)] int32`` (claimed value, VP_NONE where truthful) and
    ``stale [.., n, n] bool`` (round_tpu/byz/adversary.py::value_events).
    Equivocation wins over stale (disjoint by construction); the diagonal
    is never substituted.  ``byz_value`` is ``[.., n]``, the other genome
    leaves ``[..]``; ``r`` an int or a tensor whose dims lead."""
    byz = torch.as_tensor(byz_value) != 0
    dev = byz.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    u = _link_u32(salt0, salt1, r, n, STREAM_BYZ_VAL, dev)
    equiv = (byz[..., None, :]
             & ((u & 0xFF) < _word(equiv_p8, dev)[..., None, None])
             & ~eye)
    # the face each (src, dst) link hears is round-independent (drawn at
    # r=0 under its own stream): an equivocator tells each peer one
    # consistent story; the per-round draws only gate whether it lies
    va, vb = lie_pair(salt0, salt1, num_values, dev)
    face = (_link_u32(salt0, salt1, 0, n, STREAM_BYZ_FACE, dev) >> 8) & 1
    v = torch.where(face != 0, va[..., None, None], vb[..., None, None])
    sub_v = torch.where(equiv, v, VP_NONE).to(torch.int32)
    u2 = _link_u32(salt0, salt1, r, n, STREAM_BYZ_STALE, dev)
    stale = (byz[..., None, :] & ~equiv
             & ((u2 & 0xFF) < _word(stale_p8, dev)[..., None, None])
             & ~eye)
    return sub_v, stale


def value_plan(row, rounds: int, num_values: int,
               device=None) -> np.ndarray:
    """One genome row dict's value-fault fields as the explicit ``[rounds,
    n, n] int32`` substitution plan, bit-identical to the draws
    ``hash_adversary`` makes (round_tpu/byz/adversary.py::value_plan)."""
    dev = resolve_device(device)
    byz = torch.as_tensor(np.asarray(row["byz_value"]), device=dev)
    n = int(byz.shape[-1])
    leaves = [torch.as_tensor(np.asarray(row[f]).astype(np.int64),
                              device=dev)
              for f in ("equiv_p8", "stale_p8", "salt0", "salt1")]
    r = torch.arange(rounds, dtype=torch.int64, device=dev)
    sub_v, stale = value_events(byz, *leaves, r, n, num_values)
    plan = torch.where(stale, VP_STALE, sub_v).to(torch.int32)
    return plan.cpu().numpy()


class ValueAdversary:
    """The engine hook: per-round payload substitution inside the round
    step (engine/executor.py::run_round; round_tpu/byz/adversary.py::
    ValueAdversary).

    ``events_fn(r) -> (sub_v [n, n] int32, stale [n, n] bool)`` supplies
    the round's draws (hash- or plan-backed); ``lie`` is the protocol's
    lie model (byz/lies.py), dispatched on the static round-class index.
    ``apply`` turns the round's truthful ``[n(send), ...]`` payload tree
    into per-receiver ``[n(recv), n(send), ...]`` mailbox values and
    advances the per-class (valid, payload) stale carry."""

    def __init__(self, n: int, rounds_per_phase: int,
                 events_fn: Callable[[Any], Tuple[torch.Tensor,
                                                  torch.Tensor]],
                 lie: Optional[LieFn] = None):
        self.n = n
        self.k = max(1, rounds_per_phase)
        self.events_fn = events_fn
        self.lie = lie or generic_lie

    def init_prev(self, payload_zero) -> Tuple[torch.Tensor, Any]:
        """Fresh stale carry for one round class: (ever-sent [n] bool,
        last-sent payload zeros)."""
        leaf = tree_leaves(payload_zero)[0]
        return (torch.zeros((self.n,), dtype=torch.bool, device=leaf.device),
                tree_map(torch.zeros_like, payload_zero))

    def apply(self, j: int, r, payload, dest, prev):
        """One round's substitution.  ``j`` = static round-class index,
        ``r`` = round number, ``payload`` the truthful ``[n(send), ...]``
        tree, ``dest [n(send), n]`` the send mask, ``prev`` the class's
        stale carry.  Returns (values [n(recv), n(send), ...], new prev)."""
        n = self.n
        valid, prev_payload = prev
        sub_v, stale = self.events_fn(r)
        vmax = torch.clamp(sub_v, min=0)
        lie = self.lie

        # [n_recv, n_send, ...]: inner vmap over senders, outer over the
        # per-receiver claimed-value rows (equivocation is the outer axis)
        lied = vmap(lambda vrow: vmap(lambda p_i, v_i: lie(j, p_i, v_i))(
            payload, vrow))(vmax)

        sel_equiv = sub_v >= 0
        sel_stale = stale & valid[None, :]

        def mix(l_lied, l_truth, l_prev):
            extra = (1,) * (l_truth.dim() - 1)
            se = sel_equiv.reshape(tuple(sel_equiv.shape) + extra)
            ss = sel_stale.reshape(tuple(sel_stale.shape) + extra)
            truth = l_truth[None].expand((n,) + tuple(l_truth.shape))
            prevb = l_prev[None].expand((n,) + tuple(l_prev.shape))
            return torch.where(se, l_lied, torch.where(ss, prevb, truth))

        values = tree_map(mix, lied, payload, prev_payload)
        sent = torch.as_tensor(dest).any(dim=1)
        new_prev = (valid | sent, tree_where(sent, payload, prev_payload))
        return values, new_prev


def hash_adversary(n: int, rounds_per_phase: int, byz_value, equiv_p8,
                   stale_p8, salt0, salt1, num_values: int,
                   lie: Optional[LieFn] = None) -> ValueAdversary:
    """Hash-mode adversary over one genome's leaves
    (round_tpu/byz/adversary.py::hash_adversary)."""
    def events(r):
        return value_events(byz_value, equiv_p8, stale_p8, salt0, salt1,
                            r, n, num_values)

    return ValueAdversary(n, rounds_per_phase, events, lie=lie)


def plan_adversary(n: int, rounds_per_phase: int, plan,
                   lie: Optional[LieFn] = None,
                   device=None) -> ValueAdversary:
    """Explicit-plan adversary (``plan [T, n, n] int32``, VP_* opcodes;
    round_tpu/byz/adversary.py::plan_adversary).  Rounds past the plan
    clamp to the last row, the from_schedule convention."""
    if not isinstance(plan, torch.Tensor):
        plan = torch.as_tensor(np.asarray(plan), device=resolve_device(device))
    plan = plan.to(torch.int32)
    T = plan.shape[0]

    def events(r):
        return plan_events(plan[min(int(r), T - 1)])

    return ValueAdversary(n, rounds_per_phase, events, lie=lie)


def plan_events(row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sub_v, stale)`` of one plan row ``[.., n, n]``: the events an
    explicit plan holds for one round."""
    return (torch.where(row >= 0, row, VP_NONE).to(torch.int32),
            row == VP_STALE)


def plan_is_trivial(plan) -> bool:
    """True when the plan holds no substitution events at all
    (round_tpu/byz/adversary.py::plan_is_trivial)."""
    if isinstance(plan, torch.Tensor):
        plan = plan.cpu().numpy()
    return bool(np.all(np.asarray(plan) == VP_NONE))
