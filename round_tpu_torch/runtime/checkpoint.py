"""Checkpoint/restore of simulation state tensors + decision logs.

Port of round_tpu/runtime/checkpoint.py, with the same on-disk layout
(state.npz with ``leaf{i}`` and ``__manifest__``, manifest.json,
decisions.tsv) and the same write-then-rename order.  The pytree is the
port's (utils/tree.py) in JAX's leaf order, so leaf i of a state is leaf i
in both packages, and every leaf is written in its own dtype: int32 stays
int32, a tensor goes to disk as the numpy array of its values.  The
manifest's ``treedef`` is the port's own tree-spec string; a checkpoint
that round_tpu wrote restores through
``interop.checkpoint_from_round_tpu``, which holds its leaves against the
template leaf by leaf.

The reference has no framework-level checkpointing (SURVEY.md §5: the
closest is the batching example's snapshot/recovery); here it is native:
the process-state pytree is arrays, so a checkpoint is an .npz plus a JSON
manifest (step, instance, rng key, tree structure), and a host replica's
durable record additionally carries its decision log
(runtime/decisions.py) as a TSV — the artifact crash-restart recovery
resumes from (runtime/chaos.py, apps/host_replica.py --checkpoint-dir).

Durability discipline: every file is write-then-rename, so a crash (or a
SIGKILL from the chaos harness) mid-overwrite can never leave a valid
manifest pointing at a torn state.npz; the manifest additionally rides
inside the npz itself, so a crash BETWEEN the two renames (new state.npz,
stale manifest.json) restores the newer consistent pair instead of
pairing an old step watermark with new state.  Restore NEVER unpickles
(allow_pickle=False) and raises ``CheckpointError`` on every corruption
mode — truncated npz, missing/garbled manifest, leaf-count or treedef
mismatch — instead of restoring garbage or swapped fields.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.decisions import DecisionLog
from round_tpu_torch.utils.tree import tree_flatten, tree_unflatten


class CheckpointError(ValueError):
    """A checkpoint that must not be restored: missing, torn, or written
    for a different state shape.  Subclasses ValueError so pre-existing
    treedef-mismatch handlers keep working."""


def _corruption(msg: str) -> CheckpointError:
    """Build a CheckpointError for a DETECTED corruption, recording it on
    the observability surface (ckpt.errors counter + ckpt_error trace
    event).  Detection sites raise through this helper rather than the
    constructor counting, so re-constructed instances (unpickling across
    a process boundary, tests building synthetic errors, semantic
    kind-mismatch raises elsewhere) cannot inflate the corruption metric.
    """
    METRICS.counter("ckpt.errors").inc()
    if TRACE.enabled:
        TRACE.emit("ckpt_error", error=msg[:200])
    return CheckpointError(msg)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array of its values (a tensor is copied to the
    host in its own dtype)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state: Any, *, step: int = 0,
         meta: Optional[Dict] = None,
         decisions: Optional[DecisionLog] = None) -> None:
    """Write `state` (any pytree of arrays) + metadata.  `path` is a
    directory; contents: state.npz + manifest.json (+ decisions.tsv when
    a DecisionLog is supplied).  Every file is written atomically, and
    the manifest ALSO rides inside the npz — state and metadata then
    share ONE rename, so a crash landing between the individual file
    renames below still leaves a restorable, mutually-consistent pair
    (see restore)."""
    t0 = time.monotonic()
    os.makedirs(path, exist_ok=True)
    leaves, treedef = tree_flatten(state)
    arrays = {f"leaf{i}": to_numpy(v) for i, v in enumerate(leaves)}
    manifest = {
        "step": int(step),
        "n_leaves": len(leaves),
        "treedef": str(treedef),
        "decisions": decisions is not None,
        "meta": meta or {},
    }
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    # write-then-rename: a crash mid-overwrite must never leave a valid
    # manifest pointing at a torn state.npz
    tmp_npz = os.path.join(path, "state.npz.tmp")
    with open(tmp_npz, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp_npz, os.path.join(path, "state.npz"))
    if decisions is not None:
        tmp_tsv = os.path.join(path, "decisions.tsv.tmp")
        decisions.dump_tsv(tmp_tsv)
        os.replace(tmp_tsv, os.path.join(path, "decisions.tsv"))
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, os.path.join(path, "manifest.json"))
    METRICS.counter("ckpt.saves").inc()
    METRICS.histogram("ckpt.save_s").observe(time.monotonic() - t0)
    if TRACE.enabled:
        TRACE.emit("ckpt_save", step=int(step), path=path,
                   n_leaves=len(leaves))


def _read_manifest(path: str) -> Dict:
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as fh:
            return json.load(fh)
    except FileNotFoundError:
        # absence is not corruption: callers probe fresh directories
        # (exists() races aside) — keep it off the ckpt.errors metric
        raise CheckpointError(f"no checkpoint manifest at {mpath}") from None
    except (OSError, ValueError) as e:
        raise _corruption(f"unreadable checkpoint manifest "
                          f"{mpath}: {e}") from e


def read_leaves(path: str) -> Tuple[list, Dict]:
    """(leaves, manifest) of a checkpoint directory, the npz-embedded
    manifest winning over a stale manifest.json (see restore).  Raises
    CheckpointError on a missing manifest or a corrupt state.npz."""
    manifest = _read_manifest(path)
    npz = os.path.join(path, "state.npz")
    try:
        # allow_pickle=False is load's default but the no-unpickling
        # guarantee is part of this function's contract — keep it explicit
        data = np.load(npz, allow_pickle=False)
        if "__manifest__" in data:
            embedded = json.loads(bytes(data["__manifest__"]).decode())
            if embedded != manifest:
                # a crash landed between save()'s state.npz and
                # manifest.json renames: the npz + its embedded manifest
                # are the newer CONSISTENT pair (one rename wrote both);
                # honoring the stale manifest.json would pair its old
                # step with the new state — an SMR restore would then
                # re-apply already-applied instances
                manifest = embedded
        leaves = [data[f"leaf{i}"] for i in range(manifest["n_leaves"])]
    except CheckpointError:
        raise
    except Exception as e:  # noqa: BLE001 — BadZipFile, zlib errors,
        # KeyError on missing members, OSError on truncation: every
        # corruption mode surfaces as one clean error class
        raise _corruption(
            f"corrupt or truncated checkpoint state at {npz}: {e}") from e
    return leaves, manifest


def check_leaf_count(leaves: list, like_leaves: list) -> None:
    if len(like_leaves) != len(leaves):
        raise _corruption(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(like_leaves)}"
        )


def restored(path: str, leaves: list, treedef, manifest: Dict
             ) -> Tuple[Any, int, Dict]:
    """The (state, step, meta) of a checked restore, counted and traced."""
    state = tree_unflatten(leaves, treedef)
    METRICS.counter("ckpt.restores").inc()
    if TRACE.enabled:
        TRACE.emit("ckpt_restore", step=int(manifest["step"]), path=path)
    return state, manifest["step"], manifest.get("meta", {})


def restore(path: str, like: Any) -> Tuple[Any, int, Dict]:
    """Read a checkpoint written by `save`.  `like` supplies the pytree
    structure (same treedef as the saved state).  Returns
    (state, step, meta), the leaves numpy arrays.  Raises CheckpointError
    (a ValueError) on any corruption: missing manifest, truncated/garbled
    state.npz, leaf count or treedef mismatch — never unpickles, never
    restores swapped fields."""
    leaves, manifest = read_leaves(path)
    like_leaves, treedef = tree_flatten(like)
    check_leaf_count(leaves, like_leaves)
    # leaf count alone lets a reordered pytree restore with fields swapped;
    # the recorded treedef string must match the template's exactly
    if manifest.get("treedef") is not None and manifest["treedef"] != str(treedef):
        raise _corruption(
            "checkpoint treedef does not match the restore template:\n"
            f"  saved:    {manifest['treedef']}\n"
            f"  template: {treedef}"
        )
    return restored(path, leaves, treedef, manifest)


def restore_decisions(path: str) -> DecisionLog:
    """The decision log saved alongside a checkpoint (save(...,
    decisions=...)).  Raises CheckpointError when the checkpoint carries
    none."""
    manifest = _read_manifest(path)
    tsv = os.path.join(path, "decisions.tsv")
    if not manifest.get("decisions") or not os.path.exists(tsv):
        raise CheckpointError(f"checkpoint at {path} has no decision log")
    return DecisionLog.load_tsv(tsv)


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))
