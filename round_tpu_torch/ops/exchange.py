"""The exchange — the framework's "network".

Port of round_tpu/ops/exchange.py.  One round of communication for all n
processes is a single masked tensor exchange:

    deliver[j, i] = HO[j, i] & dest_mask[i, j] & active[i]

i.e. receiver j hears sender i iff the HO set of j contains i (the fault
model), i actually addressed j this round, and i's instance is still running.
This is the reference's ``mailboxLink`` axiom (TransitionRelation.scala:73-91).
"""

from __future__ import annotations

from typing import Any, Optional

import torch


def deliver_mask(
    ho: torch.Tensor,
    dest_mask: torch.Tensor,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ``[n_recv, n_send]`` delivery matrix.

    ho[j, i] = "j hears from i"; dest_mask[i, d] = "i sends to d";
    active [n] bool: inactive (exited/crashed) lanes send nothing.
    Returns deliver[j, i] = "j's mailbox contains i's msg"."""
    d = ho & dest_mask.T
    if active is not None:
        d = d & active[None, :]
    return d


def exchange(
    payload: Any,
    dest_mask: torch.Tensor,
    ho: torch.Tensor,
    active: Optional[torch.Tensor] = None,
):
    """Full exchange: returns (values, deliver) where values is the shared
    sender-axis payload pytree and deliver the ``[n_recv, n_send]`` mask."""
    return payload, deliver_mask(ho, dest_mask, active)


def _as_long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def ho_block(colmask, side, salt0, salt1r, p8, jg=None) -> torch.Tensor:
    """``[.., m, n]`` receiver-block rows of the hash-mode HO matrix at
    GLOBAL receiver ids ``jg`` (default ``arange(n)``: the dense matrix):

        ho[.., j, i] = (colmask[i] ∧ side[j] = side[i] ∧ keep(j, i)) ∨ (i = j)

    with keep(j, i) the murmur3-finalized link draw at flat index j·n + i,
    ``fmix32((j·n + i)·GOLD + salt0 ^ salt1r) & 0xFF >= p8`` (or p8 <= 0).
    Bit-exact with round_tpu/ops/exchange.py::ho_block.  Leading batch dims
    broadcast; salts/p8 may be ints, scalars or ``[..]`` tensors (salts as
    int32 bit patterns or uint32 values)."""
    from round_tpu_torch.ops.fused import _GOLD, _fmix32, _u32  # fused imports us

    colmask = torch.as_tensor(colmask)
    dev = colmask.device
    n = colmask.shape[-1]
    i = torch.arange(n, dtype=torch.int64, device=dev)
    if jg is None:
        jg = torch.arange(n, dtype=torch.int64, device=dev)
    jg = torch.as_tensor(jg, device=dev).to(torch.int64)
    idx = jg[:, None] * n + i[None, :]
    s0 = _u32(_as_long(salt0, dev))[..., None, None]
    s1 = _u32(_as_long(salt1r, dev))[..., None, None]
    p8 = _as_long(p8, dev)
    z = _u32(idx * _GOLD + s0) ^ s1
    keep = (_fmix32(z) & 0xFF) >= p8[..., None, None]
    keep = keep | (p8 <= 0)[..., None, None]
    side = torch.as_tensor(side, device=dev)
    side_rows = torch.index_select(side, -1, jg)
    ho = ((colmask != 0)[..., None, :]
          & (side_rows[..., :, None] == side[..., None, :]) & keep)
    eye = i[None, :] == jg[:, None]
    return ho | eye


def hist_pack(payload: torch.Tensor, sending: torch.Tensor) -> torch.Tensor:
    """Fold a histogram subround's (payload, sender-eligibility) pair into
    ONE wire tensor: ``code = payload + 1`` where the lane transmits, 0
    (silence) otherwise."""
    return torch.where(sending, payload.to(torch.int32) + 1, 0).to(torch.int32)


def hist_code_counts(code_full, ho, num_values: int) -> torch.Tensor:
    """``[.., V, m]`` receiver-block histogram counts from the packed sender
    codes (``hist_pack``) and the block's HO rows:

        counts[.., v, j] = #{ i : ho[.., j, i] ∧ code[.., i] = v + 1 }

    Exact int32 sums, so packed and unpacked paths are bit-identical."""
    code_full = torch.as_tensor(code_full)
    oh = (code_full[..., None, :]
          == (1 + torch.arange(num_values, dtype=code_full.dtype,
                               device=code_full.device))[None, :, None])
    ho = torch.as_tensor(ho)
    return (oh[..., :, None, :] & (ho != 0)[..., None, :, :]).to(
        torch.int32).sum(dim=-1, dtype=torch.int32)
