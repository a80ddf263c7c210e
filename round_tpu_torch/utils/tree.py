"""Small pytree helpers used across the engine.

Port of round_tpu/utils/tree.py.  States are frozen dataclasses of tensors
(``struct``, standing in for ``flax.struct.dataclass``), registered with
torch's pytree so ``torch.func.vmap`` and the helpers below walk them."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils._pytree as pytree


def struct(cls):
    """Frozen dataclass of tensors with ``replace``, registered as a pytree
    node (every field is a child; a None field is no child at all, so
    ``tree_map`` never sees it — torch's pytree would take it for a
    leaf)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = tuple(f.name for f in dataclasses.fields(cls))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def flatten(obj):
        values = [getattr(obj, k) for k in names]
        return ([v for v in values if v is not None],
                tuple(v is not None for v in values))

    def unflatten(children, present):
        it = iter(children)
        return cls(*[next(it) if p else None for p in present])

    cls.replace = replace
    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
    )
    return cls


def tree_map(fn, *trees):
    return pytree.tree_map(fn, *trees)


def tree_leaves(tree):
    return pytree.tree_leaves(tree)


def tree_where(cond, on_true: Any, on_false: Any) -> Any:
    """Elementwise select between two identically-shaped pytrees.

    ``cond`` broadcasts against each leaf from the left (a ``[n]`` lane mask
    selects whole per-lane subtrees)."""

    def _sel(t, f):
        c = cond
        # right-pad cond's shape so it broadcasts over trailing value dims
        extra = t.dim() - c.dim()
        if extra > 0:
            c = c.reshape(tuple(c.shape) + (1,) * extra)
        return torch.where(c, t, f)

    return pytree.tree_map(_sel, on_true, on_false)


def tree_stack(trees):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_select_lane(tree: Any, idx) -> Any:
    return pytree.tree_map(lambda x: x[idx], tree)


def _sorted_dicts(tree):
    if isinstance(tree, dict):
        return {k: _sorted_dicts(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_sorted_dicts(x) for x in tree)
    return tree


def tree_flatten(tree):
    """(leaves, spec) in JAX's leaf order: a dict's values by sorted key
    (torch's pytree keeps insertion order), so leaf i of a state is leaf i
    of the same state in round_tpu (jax.tree_util.tree_flatten)."""
    return pytree.tree_flatten(_sorted_dicts(tree))


def tree_unflatten(leaves, spec):
    return pytree.tree_unflatten(leaves, spec)


def pack_bytes(tensors) -> torch.Tensor:
    """The tensors (all on one device) as one uint8 buffer, each at an
    8-byte aligned offset so ``unpack_bytes`` can view it back."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(torch.nn.functional.pad(b, (0, -b.numel() % 8)))
    return torch.cat(parts)


def unpack_bytes(buf: torch.Tensor, like) -> list:
    """Views of ``buf`` (from ``pack_bytes``) with the dtypes and shapes of
    the tensors ``like``, on ``buf``'s device."""
    out, at = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        out.append(buf[at:at + nbytes].view(t.dtype).reshape(t.shape))
        at += nbytes + (-nbytes % 8)
    return out


def tree_to(tree: Any, device) -> Any:
    """Every tensor leaf of ``tree`` on ``device`` through ONE copy: the
    leaves found elsewhere (all on one device) are packed as bytes into one
    buffer, copied, and viewed back there.  Leaves already on ``device``
    are kept as they are."""
    leaves, spec = pytree.tree_flatten(tree)
    dev = torch.device(device)
    move = [i for i, t in enumerate(leaves) if t.device != dev]
    if not move:
        return tree
    src = [leaves[i] for i in move]
    for i, t in zip(move, unpack_bytes(pack_bytes(src).to(dev), src)):
        leaves[i] = t
    return pytree.tree_unflatten(leaves, spec)
