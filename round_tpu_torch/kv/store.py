"""KV writes: typed records through LastVotingBytes, per-shard apply.

The write path (docs/KV.md "write path"): a client encodes one
``(key, seq, value)`` record into the uint8[B] proposal vector of a
LastVotingBytes instance, the fleet ring routes the instance to the
shard owning the KEY (runtime/fleet.py ShardMap.owner_key), and the
shard's consensus decides the record — uniform proposals, so by
validity the decision IS the record.  Every replica applies decided
records IN DECISION ORDER to its ``KVState``; the decision stream of a
key's shard is that key's per-key decision stream.

Record layout (fixed 16-byte header, then pairs, zero-padded to B):

    0      magic 0xC5 (a non-record lvb payload decodes to None)
    1      op: PUT | TXN | PREPARE | COMMIT | ABORT
    2-5    txn id u32 LE (0 for plain PUT)
    6      npairs
    7      reserved
    8-9    kidx u16 LE  — first pair's key INDEX (stable hash mod K),
                          the SMR array rider's key coordinate
    10-13  digest u32 LE — first pair's value digest (array rider)
    14-15  reserved
    16..   pairs: seq u32 | klen u8 | vlen u8 | key | value

The host-side ``KVState`` is the authoritative store (byte keys/values,
txn vote table, locks); ``kv_array_machine`` is the same PUT stream as
a pure fold over a fixed keyspace on the device — a per-shard state
machine riding runtime/smr.py's ReplicatedStateMachine
(payload="bytes"), so the decided record log replays on the device to
the same (seq, digest) tables the host store holds.

Port of round_tpu/kv/store.py.  The record codec, ``key_index`` and
``value_digest`` (blake2b) and ``KVState`` are round_tpu's, byte for
byte.  ``kv_array_apply`` is a torch fold: torch has no uint32
arithmetic, so the digest table is held as int64 with its values below
2^32 (the ReplicatedStateMachine rule for a uint32 state leaf), which
keeps the digest compare unsigned; the checkpoint writes it back as
uint32.  The ``win`` select stays on the device: no value of a record
is read back to the host.
"""

from __future__ import annotations

import dataclasses
import struct
from hashlib import blake2b
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime.log import get_logger

log = get_logger("kv")

MAGIC = 0xC5
OP_PUT = 1       # one or more (key, seq, value) pairs, applied atomically
OP_TXN = 2       # single-shard multi-key transaction (atomic multi-PUT)
OP_PREPARE = 3   # cross-shard 2PC: lock + buffer, vote = determinism
OP_COMMIT = 4    # cross-shard 2PC: apply the buffered pairs, unlock
OP_ABORT = 5     # cross-shard 2PC: drop the buffer, unlock

_TXN_OPS = (OP_TXN, OP_PREPARE, OP_COMMIT, OP_ABORT)
_HDR = 16
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")

# the reserved key prefix transaction votes are READ under (kv/txn.py:
# the coordinator learns a shard's deterministic vote via a linearizable
# read of this key — votes are replicated state, not a side channel)
TXN_VOTE_PREFIX = b"\x00t"

# kv.* vocabulary (docs/OBSERVABILITY.md)
_C_APPLIED = METRICS.counter("kv.applied")
_C_TXN_FRAMES = METRICS.counter("kv.txn_frames")
_C_TXN_COMMITS = METRICS.counter("kv.txn_commits")
_C_TXN_ABORTS = METRICS.counter("kv.txn_aborts")
_C_BAD_RECORDS = METRICS.counter("kv.bad_records")


def key_index(key: bytes, keyspace: int = 4096) -> int:
    """The stable key index for the SMR array rider: blake2b mod K —
    deterministic across processes like the ring placement."""
    return int.from_bytes(blake2b(key, digest_size=8).digest(),
                          "big") % keyspace


def value_digest(value: bytes) -> int:
    """u32 value digest carried in the record header (array rider)."""
    return int.from_bytes(blake2b(value, digest_size=4).digest(), "big")


def encode_record(op: int, pairs: List[Tuple[int, bytes, bytes]],
                  payload_bytes: int, txn: int = 0,
                  keyspace: int = 4096) -> np.ndarray:
    """Encode one record as the uint8[B] lvb proposal vector.
    ``pairs`` is [(seq, key, value), ...]."""
    if not pairs:
        raise ValueError("a KV record needs at least one pair")
    if len(pairs) > 255:
        raise ValueError(f"{len(pairs)} pairs > 255")
    body = bytearray()
    for seq, key, value in pairs:
        if len(key) > 255 or len(value) > 255:
            raise ValueError("key/value longer than 255 bytes")
        body += _U32.pack(int(seq) & 0xFFFFFFFF)
        body.append(len(key))
        body.append(len(value))
        body += key
        body += value
    total = _HDR + len(body)
    if total > payload_bytes:
        raise ValueError(
            f"record needs {total} bytes > payload_bytes={payload_bytes}")
    row = np.zeros(payload_bytes, dtype=np.uint8)
    hdr = bytearray(_HDR)
    hdr[0] = MAGIC
    hdr[1] = op
    hdr[2:6] = _U32.pack(int(txn) & 0xFFFFFFFF)
    hdr[6] = len(pairs)
    hdr[8:10] = _U16.pack(key_index(pairs[0][1], keyspace))
    hdr[10:14] = _U32.pack(value_digest(pairs[0][2]))
    row[:_HDR] = np.frombuffer(bytes(hdr), dtype=np.uint8)
    row[_HDR:total] = np.frombuffer(bytes(body), dtype=np.uint8)
    return row


def decode_record(row) -> Optional[Dict[str, Any]]:
    """Decode one uint8[B] row; None when it is not a KV record (the
    shard may serve non-KV lvb traffic on the same lanes)."""
    arr = np.asarray(row)
    if arr.ndim != 1 or arr.size < _HDR or int(arr[0]) != MAGIC:
        return None
    raw = arr.astype(np.uint8).tobytes()
    op = raw[1]
    if op not in (OP_PUT,) + _TXN_OPS:
        return None
    txn = _U32.unpack_from(raw, 2)[0]
    npairs = raw[6]
    pairs: List[Tuple[int, bytes, bytes]] = []
    off = _HDR
    for _ in range(npairs):
        if off + 6 > len(raw):
            return None
        seq = _U32.unpack_from(raw, off)[0]
        klen, vlen = raw[off + 4], raw[off + 5]
        off += 6
        if off + klen + vlen > len(raw):
            return None
        pairs.append((seq, raw[off:off + klen],
                      raw[off + klen:off + klen + vlen]))
        off += klen + vlen
    if not pairs:
        return None
    return {"op": op, "txn": txn, "pairs": pairs}


class KVState:
    """The per-shard replicated state: key -> (seq, value), plus the
    transaction table (votes, buffered pairs, locks)
    (round_tpu/kv/store.py::KVState).

    Each write is its own consensus instance, and instances COMPLETE in
    different orders on different replicas (lanes run concurrently), so
    the register fold must be commutative: a pair lands only when it
    WINS the stored pair under a total order — seq first, value digest
    (then raw value) breaking seq ties.  Replicas then converge to one
    winner per key whatever their local completion interleave.  The
    tie-break matters the moment TWO clients write one key: each
    allocates seqs from its own per-key counter, so equal seqs with
    different values are a normal race.  Within one client, seqs are
    per-key monotonic, so seq order IS that writer's program order."""

    def __init__(self):
        self.data: Dict[bytes, Tuple[int, bytes]] = {}
        self.txns: Dict[int, Dict[str, Any]] = {}
        self.locks: Dict[bytes, int] = {}
        self.applied = 0
        self.txn_commits = 0
        self.txn_aborts = 0

    def get(self, key: bytes) -> Tuple[int, bytes]:
        """(seq, value); (0, b"") for a never-written key.  The txn-vote
        prefix reads the vote table: value b"y"/b"n", seq = txn id."""
        if key.startswith(TXN_VOTE_PREFIX):
            txn = int.from_bytes(key[len(TXN_VOTE_PREFIX):], "big")
            t = self.txns.get(txn)
            if t is None:
                return (0, b"")
            return (txn, b"y" if t["vote"] else b"n")
        return self.data.get(key, (0, b""))

    @staticmethod
    def _wins(seq: int, value: bytes, cur: Tuple[int, bytes]) -> bool:
        """The fold's total order: higher seq wins; equal seqs break by
        value digest then raw value — stable across replicas, so every
        apply interleave converges to the SAME survivor.  The array
        rider folds the same order over its digest table."""
        cseq, cval = cur
        if seq != cseq:
            return seq > cseq
        if value == cval:
            return True  # re-applying the stored pair is a no-op
        return ((value_digest(value), value)
                > (value_digest(cval), cval))

    def _put_all(self, pairs) -> None:
        for seq, key, value in pairs:
            seq, value = int(seq), bytes(value)
            if self._wins(seq, value, self.data.get(key, (0, b""))):
                self.data[key] = (seq, value)

    def apply(self, rec: Dict[str, Any]) -> None:
        """Fold one decided record, in decision order."""
        op, pairs, txn = rec["op"], rec["pairs"], rec["txn"]
        self.applied += 1
        _C_APPLIED.inc()
        if op in (OP_PUT, OP_TXN):
            self._put_all(pairs)
            if op == OP_TXN:
                self.txn_commits += 1
                _C_TXN_COMMITS.inc()
            return
        if op == OP_PREPARE:
            if txn in self.txns:
                return  # idempotent: a re-decided prepare cannot re-vote
            conflict = any(self.locks.get(k, txn) != txn
                           for _s, k, _v in pairs)
            self.txns[txn] = {"vote": not conflict, "pairs": pairs,
                              "done": False}
            if not conflict:
                for _s, k, _v in pairs:
                    self.locks[k] = txn
            return
        t = self.txns.get(txn)
        if t is None or t["done"]:
            return  # commit/abort without (or after) a live prepare
        t["done"] = True
        if t["vote"]:
            for _s, k, _v in t["pairs"]:
                if self.locks.get(k) == txn:
                    del self.locks[k]
        if op == OP_COMMIT and t["vote"]:
            self._put_all(t["pairs"])
            self.txn_commits += 1
            _C_TXN_COMMITS.inc()
        else:
            self.txn_aborts += 1
            _C_TXN_ABORTS.inc()


@dataclasses.dataclass
class KvConfig:
    """Driver-facing KV switches (apps/kv.py serve --kv...).

    lease_ms:       lease staleness bound; 0 derives it from the round
                    deadline via rv.compile.lease_bound_ms.
    lease_replica:  which replica answers lease reads (the router sends
                    lease reads there only; deterministic, no election).
    keyspace:       array-rider key index space (key_index mod K).
    broken_lease:   the INJECTED stale-lease fixture (tests + docs
                    only): the lease replica freezes each key's answer
                    at its first lease read and ignores the staleness
                    clock — kv/lin.py must CATCH it.
    """

    lease_ms: float = 0.0
    lease_replica: int = 0
    keyspace: int = 4096
    broken_lease: bool = False


class KVShard:
    """One replica's server-side KV view, embedded in its LaneDriver:
    the applied ``KVState``, the pending-write barrier for linearizable
    reads, and the lease clock (rv/compile.py LeaseClock)
    (round_tpu/kv/store.py::KVShard)."""

    def __init__(self, cfg: KvConfig, *, node: int, n: int,
                 timeout_ms: float):
        from round_tpu_torch.rv.compile import LeaseClock, lease_bound_ms

        self.cfg = cfg
        self.node = node
        self.n = n
        self.state = KVState()
        bound = cfg.lease_ms or lease_bound_ms(timeout_ms)
        self.lease = LeaseClock(n, node, bound)
        # iid -> keys touched: proposals SEEN (queued or live) but not
        # yet applied — the linearizable read barrier.  Per-link FIFO
        # means a read arriving after the router's PROPOSE finds the
        # write here (or already applied), so the barrier is exact for
        # writes acked before the read was issued.
        self.pending: Dict[int, Set[bytes]] = {}
        self._frozen: Dict[bytes, Tuple[int, bytes]] = {}
        self.reads_lin = 0
        self.reads_lease = 0
        self.reads_stale = 0
        self.lease_refused = 0
        self.lease_barrier = 0
        self.txn_frames = 0

    # -- write path --------------------------------------------------------

    def note_propose(self, iid: int, row) -> None:
        rec = decode_record(row)
        if rec is None:
            return
        keys = {k for _s, k, _v in rec["pairs"]}
        if rec["op"] == OP_PREPARE:
            # the vote materializes when the prepare APPLIES: the
            # coordinator's linearizable vote read must wait behind it
            keys.add(TXN_VOTE_PREFIX
                     + int(rec["txn"]).to_bytes(4, "big"))
        self.pending[iid] = keys

    def is_txn_record(self, row) -> bool:
        rec = decode_record(row)
        if rec is None or rec["op"] not in _TXN_OPS:
            _C_BAD_RECORDS.inc()
            return False
        self.txn_frames += 1
        _C_TXN_FRAMES.inc()
        return True

    def on_decision(self, iid: int, decided: bool, raw) -> None:
        """One completed instance, in decision order: apply and release
        the read barrier (an undecided instance releases it too — there
        is nothing left to wait for).  A DECIDED instance also feeds the
        lease clock: the decision was formed by a live quorum moments
        ago, which is the freshness evidence the staleness bound
        wants."""
        self.pending.pop(iid, None)
        if not decided or raw is None:
            return
        self.lease.note_quorum()
        rec = decode_record(raw)
        if rec is not None:
            self.state.apply(rec)

    # -- read path helpers (kv/reads.py owns the grades) -------------------

    def barrier_for(self, key: bytes) -> Set[int]:
        """The write instances a linearizable read of ``key`` must wait
        behind: every seen-but-unapplied instance touching the key."""
        return {iid for iid, keys in self.pending.items() if key in keys}

    def answer(self, key: bytes) -> Tuple[int, bytes]:
        return self.state.get(key)

    def lease_answer(self, key: bytes) -> Optional[Tuple[int, bytes]]:
        """The lease replica's local answer, or None = REFUSE (stale
        clock).  The broken-lease fixture freezes each key's first
        answer and never refuses — exactly the contract violation the
        checker exists to catch."""
        if self.cfg.broken_lease:
            if key not in self._frozen:
                self._frozen[key] = self.state.get(key)
            return self._frozen[key]
        if not self.lease.valid():
            self.lease_refused += 1
            return None
        if self.barrier_for(key):
            # a seen-but-unapplied write touches the key: its client
            # may already hold an ack through another replica's
            # decision stream — refuse, the client re-runs as lin
            self.lease_refused += 1
            self.lease_barrier += 1
            return None
        return self.state.get(key)

    def fill_stats(self, stats_out: Optional[Dict[str, Any]]) -> None:
        if stats_out is None:
            return
        for k, v in (("kv_applied", self.state.applied),
                     ("kv_reads_lin", self.reads_lin),
                     ("kv_reads_lease", self.reads_lease),
                     ("kv_reads_stale", self.reads_stale),
                     ("kv_lease_refused", self.lease_refused),
                     ("kv_lease_barrier", self.lease_barrier),
                     ("kv_lease_grants", self.lease.grants),
                     ("kv_txn_frames", self.txn_frames),
                     ("kv_txn_commits", self.state.txn_commits),
                     ("kv_txn_aborts", self.state.txn_aborts)):
            stats_out[k] = stats_out.get(k, 0) + v


# -- the SMR array rider ---------------------------------------------------

def _le(cmd: torch.Tensor, at: int, width: int) -> torch.Tensor:
    """The little-endian unsigned word of ``width`` bytes at ``at``, as
    an int64 0-d tensor on the record's device."""
    word = cmd[at].to(torch.int64)
    for i in range(1, width):
        word = word | (cmd[at + i].to(torch.int64) << (8 * i))
    return word


def kv_array_apply(state, cmd: torch.Tensor):
    """The pure fold for runtime/smr.py ReplicatedStateMachine
    (payload="bytes") (round_tpu/kv/store.py::kv_array_apply): state =
    (seqs int32[K], digests int64[K] holding u32), cmd = one decided
    uint8[B] record row on the same device.  PUT rows land their header
    coordinate (kidx, seq of the first pair, value digest); non-PUT and
    non-record rows are no-ops — the array rider tracks the plain write
    stream, the host KVState is authoritative for transactions.  Every
    step is a device op: the record's fields, the ``win`` select and the
    stores never come back to the host."""
    seqs, digs = state
    assert cmd.shape[0] >= _HDR, "record rows are at least one header wide"
    is_put = (cmd[0] == MAGIC) & (cmd[1] == OP_PUT)
    kidx = (_le(cmd, 8, 2) % seqs.shape[0]).reshape(1)
    dig = _le(cmd, 10, 4)
    # round_tpu assembles the seq in int32 shifts, so a high byte >= 128
    # reads as a negative int32: the same two's-complement word here
    seq = _le(cmd, _HDR, 4)
    seq = torch.where(seq >= 1 << 31, seq - (1 << 32), seq).to(torch.int32)
    # the same total order as KVState._wins: instance completion order
    # differs per replica, so the fold must be commutative to converge —
    # seq first, digest breaking seq ties (the raw-value tail of the host
    # tie-break only matters under a u32 digest collision, where the
    # (seq, digest) table is identical either way); the digests are held
    # in int64, so ``>=`` is round_tpu's unsigned compare
    cur_seq, cur_dig = seqs[kidx], digs[kidx]
    win = is_put & ((seq > cur_seq) | ((seq == cur_seq) & (dig >= cur_dig)))
    seqs = seqs.index_put((kidx,), torch.where(win, seq, cur_seq))
    digs = digs.index_put((kidx,), torch.where(win, dig, cur_dig))
    return (seqs, digs)


def kv_array_machine(n: int, ho_sampler, *, payload_bytes: int,
                     keyspace: int = 4096, window: int = 16, device=None):
    """A per-shard KV state machine riding ReplicatedStateMachine
    (round_tpu/kv/store.py::kv_array_machine): the consensus payload is
    the raw record row (payload="bytes", the LastVotingBytes role) and
    the applied state is the (seq, digest) table on ``device`` (the card
    unless the caller passes another) — replaying a shard's decided
    record log through this machine gives the host KVState's tables.
    The digest leaf is declared uint32 (held as int64 on the device)."""
    from round_tpu_torch.models.lastvoting import LastVotingBytes
    from round_tpu_torch.runtime.smr import ReplicatedStateMachine

    init = (np.zeros(keyspace, np.int32), np.zeros(keyspace, np.uint32))
    return ReplicatedStateMachine(
        LastVotingBytes(payload_bytes=payload_bytes), n,
        kv_array_apply, init, ho_sampler,
        batch_size=payload_bytes, window=window, payload="bytes",
        device=device)
