"""Multi-key transactions riding the TwoPhaseCommit model (docs/KV.md).

Participant shards are resolved by the ring (one per distinct key
owner).  Two shapes:

  * single-shard: ALL keys hash to one shard — the transaction is one
    atomic ``OP_TXN`` record (one consensus decision applies every
    pair), no coordination protocol at all;

  * cross-shard: client-coordinated 2PC whose every step is itself a
    replicated decision.  ``OP_PREPARE`` records (FLAG_TXN verb) decide
    on each participant; each shard's VOTE is the deterministic lock-
    conflict outcome of applying the prepare in decision order (every
    replica computes the same vote — no vote message exists to lose),
    read back via a linearizable read of the reserved vote key
    (store.TXN_VOTE_PREFIX).  The commit calculus over the collected
    votes then RIDES THE TPC MODEL: ``tpc_decide`` runs the
    TwoPhaseCommit algorithm (models/tpc.py) on the engine with one
    process per participant shard and can_commit = its vote, and the
    coordinator's decision is the outcome.  ``OP_COMMIT``/``OP_ABORT``
    records land the outcome on every participant (buffered pairs apply
    or drop, locks release).

A crashed coordinator leaves prepares locked; any client can finish the
protocol by reading the votes and proposing the deterministic outcome —
the records are idempotent (KVState.apply ignores a second
commit/abort), the property 2PC needs from its log.

Port of round_tpu/kv/txn.py.  ``tpc_decide`` runs the port's
``run_instance`` on ``device`` (the card unless the caller passes
another) under the key ``(0, seed)``, the port's form of round_tpu's
``PRNGKey(seed)``; TPC draws nothing, so its decisions are round_tpu's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from round_tpu_torch.models.tpc import DEC_COMMIT, TwoPhaseCommit, tpc_io
from round_tpu_torch.obs.metrics import METRICS

_C_TXNS = METRICS.counter("kv.txns")
_C_TXN_CROSS = METRICS.counter("kv.txns_cross_shard")


def vote_key(txn: int) -> bytes:
    from round_tpu_torch.kv.store import TXN_VOTE_PREFIX

    return TXN_VOTE_PREFIX + int(txn).to_bytes(4, "big")


def tpc_decide(votes: List[bool], seed: int = 0, device=None) -> bool:
    """The commit calculus on the TPC model: one engine instance,
    n = max(2, participants), coordinator 0, full delivery (the client
    IS the network here — every vote it holds, it delivers).  Commit
    iff the coordinator decides DEC_COMMIT, i.e. all votes yes."""
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.engine.executor import run_instance
    from round_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    vs = list(votes) + [True] * max(0, 2 - len(votes))
    res = run_instance(
        TwoPhaseCommit(), tpc_io(0, vs, device=dev), len(vs),
        (0, int(seed)), scenarios.full(len(vs), device=dev), max_phases=1,
        device=dev)
    return int(np.asarray(res.state.decision.cpu())[0]) == DEC_COMMIT


def plan_txn(ring, pairs: Dict[bytes, bytes]) -> Dict[str, Dict[bytes, bytes]]:
    """Partition a write set by owning shard (the ring resolves
    participants)."""
    by_shard: Dict[str, Dict[bytes, bytes]] = {}
    for k, v in pairs.items():
        by_shard.setdefault(ring.owner_key(k), {})[k] = v
    _C_TXNS.inc()
    if len(by_shard) > 1:
        _C_TXN_CROSS.inc()
    return by_shard
