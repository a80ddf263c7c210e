"""Deterministic-order float reductions.

Port of round_tpu/ops/detsum.py.  ``torch.sum`` picks its association
order by device, dtype and size (CPU vectorisation, CUDA block reductions),
so the same logical float32 sum can round differently between two call
sites.  Protocols whose *semantics* include a float mean (ε-agreement's
trimmed mean, Epsilon.scala:56-60) pin the order instead: ``tree_sum`` is a
balanced binary tree of elementwise adds at fixed positions, and an
elementwise float32 add rounds the same way on every backend.  Any two
call sites — engines, kernels, oracles — that sum the same values through
``tree_sum`` get the same bits, in this package and in round_tpu.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# set while a round is traced for transition-relation extraction: there the
# sum must appear as one opaque reduce site, not as the add tree
_EXTRACTING = contextvars.ContextVar("detsum_extracting", default=False)


@contextlib.contextmanager
def extracting():
    """Within this context, tree_sum is a plain ``torch.sum``
    (round_tpu/ops/detsum.py::extracting).  Owns the set/reset invariant so
    call sites cannot leave the flag stuck."""
    tok = _EXTRACTING.set(True)
    try:
        yield
    finally:
        _EXTRACTING.reset(tok)


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` with a fixed balanced-tree association order
    (round_tpu/ops/detsum.py::tree_sum).

    Zero-pads to the next power of two and halves the axis with
    elementwise adds (element i with element i + half) until one element
    remains."""
    if _EXTRACTING.get():
        return torch.sum(x, dim=dim)
    x = torch.movedim(x, dim, -1)
    m = x.shape[-1]
    if m == 0:
        return x.new_zeros(x.shape[:-1])
    p = 1 << max(m - 1, 0).bit_length()
    if p != m:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - m,))], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]
