"""Replicated key-value store on multi-shot SMR (docs/KV.md).

The first APPLICATION tier: every write is a LastVotingBytes consensus
decision whose uint8[B] payload is a typed ``(key, seq, value)`` record,
applied in decision order to a per-shard state machine; reads come in
three consistency grades (linearizable round-wave read-index, leader-
lease local reads under the staleness bound, stale decision-bank
reads); multi-key transactions ride the TwoPhaseCommit model; and the
client history is checked post-hoc by a Wing&Gong-style
linearizability checker.

Port of round_tpu/kv.  The shards' lanes, the array rider's fold and the
commit calculus run on the card unless the caller asks for the CPU.
"""

from round_tpu_torch.kv.store import (  # noqa: F401
    KvConfig, KVShard, KVState, decode_record, encode_record,
    OP_PUT, OP_TXN, OP_PREPARE, OP_COMMIT, OP_ABORT,
)
from round_tpu_torch.kv.reads import (  # noqa: F401
    GRADE_LIN, GRADE_LEASE, GRADE_STALE, GRADE_NAMES,
    ST_OK, ST_REFUSED,
)
