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


def _slabs(S: int, per_row: int):
    """Slices of a leading axis of S rows, each holding at most
    ``fused._PLAIN_ELEMS`` elements at ``per_row`` elements a row: the
    int64 hash intermediates and float32 count operands of one slab stay
    near 128 MB whatever the batch."""
    from round_tpu_torch.ops.fused import _PLAIN_ELEMS  # fused imports us

    step = max(1, _PLAIN_ELEMS // max(1, per_row))
    for a in range(0, S, step):
        yield slice(a, min(S, a + step))


def _ho_block_dense(colmask, side, salt0, salt1r, p8, jg) -> torch.Tensor:
    from round_tpu_torch.ops.fused import _GOLD, _fmix32, _u32  # fused imports us

    dev = colmask.device
    n = colmask.shape[-1]
    i = torch.arange(n, dtype=torch.int64, device=dev)
    idx = jg[:, None] * n + i[None, :]
    s0 = _u32(_as_long(salt0, dev))[..., None, None]
    s1 = _u32(_as_long(salt1r, dev))[..., None, None]
    p8 = _as_long(p8, dev)
    z = _u32(idx * _GOLD + s0) ^ s1
    keep = (_fmix32(z) & 0xFF) >= p8[..., None, None]
    keep = keep | (p8 <= 0)[..., None, None]
    side_rows = torch.index_select(side, -1, jg)
    ho = ((colmask != 0)[..., None, :]
          & (side_rows[..., :, None] == side[..., None, :]) & keep)
    eye = i[None, :] == jg[:, None]
    return ho | eye


def ho_block(colmask, side, salt0, salt1r, p8, jg=None) -> torch.Tensor:
    """``[.., m, n]`` receiver-block rows of the hash-mode HO matrix at
    GLOBAL receiver ids ``jg`` (default ``arange(n)``: the dense matrix):

        ho[.., j, i] = (colmask[i] ∧ side[j] = side[i] ∧ keep(j, i)) ∨ (i = j)

    with keep(j, i) the murmur3-finalized link draw at flat index j·n + i,
    ``fmix32((j·n + i)·GOLD + salt0 ^ salt1r) & 0xFF >= p8`` (or p8 <= 0).
    Bit-exact with round_tpu/ops/exchange.py::ho_block.  Leading batch dims
    broadcast; salts/p8 may be ints, scalars or ``[..]`` tensors (salts as
    int32 bit patterns or uint32 values).  A ``[S, n]`` batch whose salts
    and p8 are ``[S]`` tensors is hashed slab by slab along S, so only the
    bool result is ever [S, m, n]."""
    colmask = torch.as_tensor(colmask)
    dev = colmask.device
    n = colmask.shape[-1]
    if jg is None:
        jg = torch.arange(n, dtype=torch.int64, device=dev)
    jg = torch.as_tensor(jg, device=dev).to(torch.int64)
    side = torch.as_tensor(side, device=dev)
    per_scenario = [torch.as_tensor(t, device=dev) for t in (salt0, salt1r, p8)]
    S = colmask.shape[0]
    if colmask.dim() != 2 or side.shape != colmask.shape or any(
            tuple(t.shape) != (S,) for t in per_scenario):
        return _ho_block_dense(colmask, side, salt0, salt1r, p8, jg)
    out = torch.empty((S, jg.shape[0], n), dtype=torch.bool, device=dev)
    for sl in _slabs(S, jg.shape[0] * n):
        out[sl] = _ho_block_dense(colmask[sl], side[sl],
                                  *(t[sl] for t in per_scenario), jg)
    return out


def hist_pack(payload: torch.Tensor, sending: torch.Tensor) -> torch.Tensor:
    """Fold a histogram subround's (payload, sender-eligibility) pair into
    ONE wire tensor: ``code = payload + 1`` where the lane transmits, 0
    (silence) otherwise."""
    return torch.where(sending, payload.to(torch.int32) + 1, 0).to(torch.int32)


def block_counts(onehot: torch.Tensor, deliver: torch.Tensor) -> torch.Tensor:
    """``counts[.., v, j] = Σ_i onehot[.., v, i] · deliver[.., j, i]`` as
    int32, for bool operands ``[.., V, n]`` and ``[.., m, n]`` with the same
    leading dims: the receiver-block count of the sharded engines
    (round_tpu computes it as an int32 einsum outside any kernel).  A
    batched float32 product of 0/1 operands, exact for sums below 2^24,
    taken slab by slab along the leading axis."""
    lead = onehot.shape[:-2]
    V, n = onehot.shape[-2:]
    m = deliver.shape[-2]
    oh = onehot.reshape(-1, V, n)
    dl = deliver.reshape(-1, m, n)
    out = torch.empty((oh.shape[0], V, m), dtype=torch.int32,
                      device=oh.device)
    for sl in _slabs(oh.shape[0], m * n):
        out[sl] = torch.bmm(oh[sl].to(torch.float32),
                            dl[sl].to(torch.float32).transpose(1, 2)
                            ).to(torch.int32)
    return out.reshape(*lead, V, m)


def hist_code_counts(code_full, ho, num_values: int) -> torch.Tensor:
    """``[.., V, m]`` receiver-block histogram counts from the packed sender
    codes (``hist_pack``) and the block's HO rows:

        counts[.., v, j] = #{ i : ho[.., j, i] ∧ code[.., i] = v + 1 }

    Exact int32 sums, so packed and unpacked paths are bit-identical
    (round_tpu/ops/exchange.py::hist_code_counts)."""
    code_full = torch.as_tensor(code_full)
    oh = (code_full[..., None, :]
          == (1 + torch.arange(num_values, dtype=code_full.dtype,
                               device=code_full.device))[None, :, None])
    ho = torch.as_tensor(ho) != 0
    return block_counts(oh, ho.expand(*oh.shape[:-2], *ho.shape[-2:]))
