"""State-machine replication: request batching + consensus + replay/recovery.

The reference's batching example (example/batching/, example/LastVotingB.scala)
turns LastVoting into an SMR service: client requests are packed into byte
batches, each batch is one consensus instance, decisions land in a
DecisionLog, laggards recover by asking peers for missing decisions or a
snapshot (Recovery.scala).  The TPU build keeps that architecture with the
payload redesign of SURVEY.md §2.8: commands are fixed-width int records, a
batch is a [batch_size] tensor, and the consensus payload is the *batch
index* (the batch store is replicated host-side) — the analogue of
LastVotingB shipping opaque Array[Byte].

The state machine itself is a pure fold ``apply(state, cmd) -> state`` over
decided batches.

Port of round_tpu/runtime/smr.py.  round_tpu replays the decided ``[K, B]``
batches with a jitted ``jax.lax.scan``; the port folds ``apply_fn`` over
them in Python, on the device, after one copy of the ``[K, B]`` block.
The state machine's state lives on ``device`` (the card unless the caller
passes another).  ``sm_init``'s leaves declare the dtypes of the state:
torch has no uint32 arithmetic, so a uint32 leaf (numpy) is held as int64
with its values below 2^32, and ``checkpoint`` writes every leaf back in
the declared dtype, so a checkpoint of the same state has round_tpu's
bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.runtime.instances import InstancePool
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import tree_flatten, tree_unflatten


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _held(leaf, device) -> torch.Tensor:
    """A state leaf on the device; uint32 values held as int64."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        leaf = torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32
                               else a)
    return leaf.to(device)


@dataclasses.dataclass
class Snapshot:
    """State-machine state after applying instances [0, upto)."""

    upto: int
    state: Any


class ReplicatedStateMachine:
    """One replica's SMR view: propose commands, decide batches, apply in order.

    Args:
      algo: consensus algorithm over int payloads (LastVoting by default —
        the reference's LastVotingB role).
      n: group size.
      apply_fn: (sm_state, cmd_batch [B] int32, or uint8 with
        payload="bytes") -> sm_state — the replicated state machine (pure,
        on tensors of ``device``).
      sm_init: initial state-machine state; its leaves' dtypes are the
        state's (a numpy uint32 leaf is held as int64, see above).
      batch_size: commands per consensus instance (request batching).
      ho_sampler / max_phases / window / device: engine parameters for
        the underlying InstancePool.
    """

    def __init__(
        self,
        algo: Algorithm,
        n: int,
        apply_fn: Callable[[Any, torch.Tensor], Any],
        sm_init: Any,
        ho_sampler: Callable,
        batch_size: int = 8,
        max_phases: int = 6,
        window: int = 16,
        payload: str = "index",
        device=None,
    ):
        """payload="index" (default): consensus agrees on int batch
        INDICES, the batch store resolves them.
        payload="bytes": consensus agrees on the RAW uint8[batch_size]
        command batch itself — the LastVotingB role
        (example/LastVotingB.scala ships Array[Byte] through consensus;
        pair with models.lastvoting.LastVotingBytes so the decided value
        IS the replicated command bytes, end to end on-chip).  Commands
        must be 0..255; the decided log carries byte rows and replays
        them directly — no index indirection to desynchronize."""
        if payload not in ("index", "bytes"):
            raise ValueError(f"payload must be 'index' or 'bytes': {payload}")
        self.payload = payload
        self.n = n
        self.apply_fn = apply_fn
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.pool = InstancePool(algo, n, ho_sampler, max_phases, window,
                                 device=self.device)
        self.batch_store: Dict[int, np.ndarray] = {}  # batch idx -> [B] cmds
        self.decided_batches: Dict[int, int] = {}  # instance -> batch idx
        self._queue: List[int] = []
        self.next_instance = 0
        leaves, self._sm_spec = tree_flatten(sm_init)
        self._sm_dtypes = [_np_dtype(leaf) for leaf in leaves]
        self.sm_init = self._on_device(leaves)
        self._applied = Snapshot(0, self.sm_init)

    def _on_device(self, leaves) -> Any:
        return tree_unflatten([_held(leaf, self.device) for leaf in leaves],
                              self._sm_spec)

    def _replay(self, state, batches: torch.Tensor) -> Any:
        """Fold apply_fn over the [K, B] decided batches (round_tpu's
        lax.scan)."""
        for b in batches:
            state = self.apply_fn(state, b)
        return state

    # -- client side -------------------------------------------------------

    def propose(self, commands: Sequence[int]) -> None:
        """Queue client commands (RequestProcessor intake)."""
        self._queue.extend(int(c) for c in commands)

    def pending_batches(self) -> int:
        return len(self._queue) // self.batch_size

    def _next_batch(self) -> Optional[int]:
        if len(self._queue) < self.batch_size:
            return None
        cmds, self._queue = (
            self._queue[: self.batch_size],
            self._queue[self.batch_size:],
        )
        idx = len(self.batch_store)
        if self.payload == "bytes":
            if not all(0 <= c <= 255 for c in cmds):
                raise ValueError("byte commands only")
            self.batch_store[idx] = np.asarray(cmds, dtype=np.uint8)
        else:
            self.batch_store[idx] = np.asarray(cmds, dtype=np.int32)
        return idx

    # -- consensus side ----------------------------------------------------

    def run(self, key, pad_with_noop: bool = False) -> int:
        """Batch queued commands, run one consensus instance per batch,
        record decisions.  Returns the number of instances submitted.
        ``key`` is a ``(salt0, salt1)`` pair (runtime/instances.py)."""
        if pad_with_noop and self._queue and len(self._queue) < self.batch_size:
            self._queue.extend([0] * (self.batch_size - len(self._queue)))
        count = 0
        while True:
            b = self._next_batch()
            if b is None:
                break
            inst = self.next_instance
            self.next_instance = (self.next_instance + 1) % (1 << 16)
            if self.payload == "bytes":
                # every lane proposes the RAW command bytes; the decided
                # value IS the replicated batch (LastVotingB semantics)
                row = self.batch_store[b]
                self.pool.submit(inst, consensus_io(
                    np.broadcast_to(row, (self.n,) + row.shape).copy()))
            else:
                # every lane proposes the batch index (value-agreement
                # on an int, store-resolved)
                self.pool.submit(inst, consensus_io(
                    np.full((self.n,), b, dtype=np.int32)))
            count += 1
        for res in self.pool.run_all(key):
            if res.value is not None:
                self.decided_batches[res.instance_id] = (
                    np.asarray(res.value, dtype=np.uint8)
                    if self.payload == "bytes" else int(res.value))
        return count

    # -- apply / replay / recovery ----------------------------------------

    def log_gaps(self) -> List[int]:
        """Instances < next_instance with no recorded decision."""
        return [
            i for i in range(self.next_instance) if i not in self.decided_batches
        ]

    def recover_from(self, peer: "ReplicatedStateMachine") -> int:
        """Copy missing decisions (and their batches) from a peer — the
        askDecision/Decision round-trip of Recovery.scala.  Returns number
        of instances recovered."""
        def copy_one(i) -> bool:
            if i not in peer.decided_batches:
                return False
            b = peer.decided_batches[i]
            self.decided_batches[i] = b
            # byte rows ARE the commands — nothing to resolve; index
            # decisions also need the referenced batch contents
            if (self.payload == "index" and b not in self.batch_store
                    and b in peer.batch_store):
                self.batch_store[b] = peer.batch_store[b]
            return True

        got = 0
        for i in self.log_gaps():
            got += copy_one(i)
        if self.next_instance < peer.next_instance:
            for i in range(self.next_instance, peer.next_instance):
                got += copy_one(i)
            self.next_instance = peer.next_instance
        return got

    def install_snapshot(self, snap: Snapshot) -> None:
        """Adopt a peer's snapshot (the Late/writeSnapshot path)."""
        if snap.upto > self._applied.upto:
            leaves, _ = tree_flatten(snap.state)
            self._applied = Snapshot(snap.upto, self._on_device(leaves))

    def snapshot(self) -> Snapshot:
        self.apply_decided()
        return self._applied

    # -- durable crash-restart checkpoint ----------------------------------

    def checkpoint(self, path: str) -> None:
        """Durably persist this replica's SMR view — applied state-machine
        state, decision log, and batch store — via the atomic
        write-then-rename npz + manifest of runtime/checkpoint.py, with
        the decision log also dumped as the canonical TSV
        (runtime/decisions.py).  A replica killed after `checkpoint` and
        restarted with `restore_checkpoint` resumes with an identical
        log-hash to a never-crashed twin, then fills any tail gaps via
        the existing recover_from/decision-replay path."""
        from round_tpu_torch.runtime import checkpoint as _ckpt
        from round_tpu_torch.runtime.decisions import DecisionLog

        self.apply_decided()
        row_dtype = np.uint8 if self.payload == "bytes" else np.int32
        idxs = sorted(self.batch_store)
        rows = (np.stack([np.asarray(self.batch_store[i]) for i in idxs])
                if idxs else np.zeros((0, self.batch_size), row_dtype))
        insts = sorted(self.decided_batches)
        if self.payload == "bytes":
            dec = (np.stack([np.asarray(self.decided_batches[i])
                             for i in insts])
                   if insts else np.zeros((0, self.batch_size), np.uint8))
        else:
            dec = np.asarray([self.decided_batches[i] for i in insts],
                             dtype=np.int64)
        # the state machine's leaves in their declared dtypes
        sm_leaves, _ = tree_flatten(self._applied.state)
        state = {
            "sm": tree_unflatten(
                [_ckpt.to_numpy(leaf).astype(dt)
                 for leaf, dt in zip(sm_leaves, self._sm_dtypes)],
                self._sm_spec),
            "store_idx": np.asarray(idxs, dtype=np.int64),
            "store_rows": rows,
            "dec_inst": np.asarray(insts, dtype=np.int64),
            "dec_val": dec,
        }
        dlog = DecisionLog()
        for i in insts:
            d = self.decided_batches[i]
            # byte-payload decisions are rows, not scalars: log the batch
            # INDEX position so the TSV still orders/identifies them
            dlog.record(i, 0, int(d) if self.payload == "index"
                        else int(np.asarray(d)[0]))
        _ckpt.save(path, state, step=self._applied.upto,
                   meta={"kind": "smr", "payload": self.payload,
                         "batch_size": self.batch_size,
                         "next_instance": self.next_instance},
                   decisions=dlog)
        from round_tpu_torch.obs.metrics import METRICS
        from round_tpu_torch.obs.trace import TRACE

        METRICS.counter("smr.checkpoints").inc()
        if TRACE.enabled:
            TRACE.emit("smr_ckpt_save", step=self._applied.upto,
                       instances=len(insts), batches=len(idxs), path=path)

    def restore_checkpoint(self, path: str) -> int:
        """Rebuild the SMR view from a `checkpoint` directory.  Returns
        the applied-upto watermark.  Raises
        checkpoint.CheckpointError on corruption or a payload-mode
        mismatch (restoring a bytes log into an index replica would
        replay garbage commands)."""
        from round_tpu_torch.runtime import checkpoint as _ckpt

        return self._adopt_checkpoint(
            path, *_ckpt.restore(path, self._checkpoint_like()))

    def _checkpoint_like(self) -> Dict[str, Any]:
        """The restore template: the state machine's leaves in their
        declared dtypes, the logs with zero rows in the dtypes
        ``checkpoint`` writes."""
        rows = np.uint8 if self.payload == "bytes" else np.int32
        init = tree_flatten(self.sm_init)[0]
        return {
            "sm": tree_unflatten([np.zeros(tuple(leaf.shape), dt) for leaf, dt
                                  in zip(init, self._sm_dtypes)],
                                 self._sm_spec),
            "store_idx": np.zeros(0, np.int64),
            "store_rows": np.zeros((0, self.batch_size), rows),
            "dec_inst": np.zeros(0, np.int64),
            "dec_val": (np.zeros((0, self.batch_size), np.uint8)
                        if self.payload == "bytes" else np.zeros(0, np.int64)),
        }

    def _adopt_checkpoint(self, path: str, state, step: int, meta) -> int:
        """Install a restored (state, step, meta): the payload-mode check,
        the logs, the applied state on the device, next_instance."""
        from round_tpu_torch.runtime import checkpoint as _ckpt

        if meta.get("kind") != "smr" or meta.get("payload") != self.payload \
                or meta.get("batch_size") != self.batch_size:
            raise _ckpt.CheckpointError(
                f"checkpoint at {path} is not an SMR checkpoint for "
                f"payload={self.payload!r} batch_size={self.batch_size}: "
                f"meta={meta}")
        self.batch_store = {
            int(i): np.asarray(row)
            for i, row in zip(state["store_idx"], state["store_rows"])
        }
        if self.payload == "bytes":
            self.decided_batches = {
                int(i): np.asarray(row, dtype=np.uint8)
                for i, row in zip(state["dec_inst"], state["dec_val"])
            }
        else:
            self.decided_batches = {
                int(i): int(v)
                for i, v in zip(state["dec_inst"], state["dec_val"])
            }
        self._applied = Snapshot(int(step),
                                 self._on_device(tree_flatten(state["sm"])[0]))
        self.next_instance = int(meta["next_instance"])
        from round_tpu_torch.obs.metrics import METRICS
        from round_tpu_torch.obs.trace import TRACE

        METRICS.counter("smr.restores").inc()
        if TRACE.enabled:
            TRACE.emit("smr_ckpt_restore", step=int(step),
                       instances=len(self.decided_batches), path=path)
        return int(step)

    def apply_decided(self) -> Any:
        """Apply all contiguously-decided instances to the state machine."""
        upto = self._applied.upto
        batches = []
        while upto in self.decided_batches:
            d = self.decided_batches[upto]
            batches.append(d if self.payload == "bytes"
                           else self.batch_store[d])
            upto += 1
        if batches:
            new_state = self._replay(
                self._applied.state,
                torch.as_tensor(np.stack(batches)).to(self.device))
            self._applied = Snapshot(upto, new_state)
        return self._applied.state

    @property
    def applied_upto(self) -> int:
        return self._applied.upto
