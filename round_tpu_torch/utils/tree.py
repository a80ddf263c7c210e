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
    node (every field is a child; None children are empty subtrees)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = tuple(f.name for f in dataclasses.fields(cls))

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    cls.replace = replace
    pytree.register_pytree_node(
        cls,
        lambda obj: ([getattr(obj, k) for k in names], None),
        lambda children, _ctx: cls(*children),
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
