"""KV reads at three consistency grades (docs/KV.md "read grades").

  * ``lin`` — linearizable read-index: the owning shard's replicas each
    DEFER the answer behind (a) every seen-but-unapplied write instance
    touching the key (per-link FIFO puts any previously-acked write's
    PROPOSE ahead of the read on each replica link) and (b) one full
    round wave of the serve tick (a wave is the unit of progress, so
    one wave bounds any in-flight decision).  The client completes on a
    MAJORITY of OK replies and takes the max-seq answer.

  * ``lease`` — leader-lease local read: ONE designated replica answers
    immediately from applied state, licensed by the carried-state
    staleness bound (rv/compile.py LeaseClock: quorum heard within
    lease_bound_ms, lease revoked for good if the monitor trips).  A
    stale clock REFUSES and the client falls back to a linearizable
    read — refusal is the contract, not an error.

  * ``stale`` — decision-bank read: served straight from the client's
    own applied mirror of acked decisions, zero wire traffic.

Wire shape: FLAG_READ both ways, codec-dict payloads
``{r, k, g}`` -> ``{r, st, seq, v}`` (runtime/oob.py).

Port of round_tpu/kv/reads.py, unchanged: the read and reply bytes are
the port's codec's, which are round_tpu's byte for byte.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.oob import FLAG_READ, Tag

GRADE_LIN = 0
GRADE_LEASE = 1
GRADE_STALE = 2
GRADE_NAMES = {GRADE_LIN: "lin", GRADE_LEASE: "lease",
               GRADE_STALE: "stale"}

ST_OK = 0
ST_REFUSED = 1

# kv.* read vocabulary (docs/OBSERVABILITY.md)
C_READS = {g: METRICS.counter(f"kv.reads_{name}")
           for g, name in GRADE_NAMES.items()}
C_LEASE_REFUSED = METRICS.counter("kv.lease_refusals")
C_LEASE_FALLBACKS = METRICS.counter("kv.lease_fallbacks")
H_READ_MS = {name: METRICS.histogram(
    f"kv.read_{name}_ms", (0.1, 0.5, 1, 2, 5, 10, 20, 50, 100, 500),
    unit="ms") for name in GRADE_NAMES.values()}


def encode_read(rid: int, key: bytes, grade: int) -> bytes:
    return codec.encode({"r": int(rid), "k": bytes(key), "g": int(grade)})


def decode_read(raw) -> Optional[Dict[str, Any]]:
    try:
        d = codec.loads(bytes(raw))
    except Exception:  # noqa: BLE001 — garbage read frames drop
        return None
    if not isinstance(d, dict) or not {"r", "k", "g"} <= set(d):
        return None
    return {"r": int(d["r"]), "k": bytes(d["k"]), "g": int(d["g"])}


def encode_reply(rid: int, status: int, seq: int, value: bytes) -> bytes:
    return codec.encode({"r": int(rid), "st": int(status),
                         "seq": int(seq), "v": bytes(value)})


def decode_reply(raw) -> Optional[Dict[str, Any]]:
    try:
        d = codec.loads(bytes(raw))
    except Exception:  # noqa: BLE001 — garbage replies drop
        return None
    if not isinstance(d, dict) or not {"r", "st", "seq", "v"} <= set(d):
        return None
    return {"r": int(d["r"]), "st": int(d["st"]), "seq": int(d["seq"]),
            "v": bytes(d["v"])}


def read_tag(rid: int) -> Tag:
    """Reads ride FLAG_READ with the 16-bit read id in Tag.instance —
    correlation for shedding's FLAG_NACK only, never a consensus id
    (the payload carries the full rid)."""
    iid = rid & 0xFFFF
    return Tag(instance=iid if iid else 1, flag=FLAG_READ)


def serve_read(kv, sender: int, rid: int, key: bytes, grade: int,
               transport) -> bool:
    """Answer one immediately-serviceable read (lease/stale grades) on
    the server; returns False when the grade needs the caller's
    round-wave queue (lin) instead.  ``kv`` is a kv.store.KVShard."""
    if grade == GRADE_LEASE:
        kv.reads_lease += 1
        C_READS[GRADE_LEASE].inc()
        ans = kv.lease_answer(key)
        if ans is None:
            C_LEASE_REFUSED.inc()
            transport.send(sender, read_tag(rid),
                           encode_reply(rid, ST_REFUSED, 0, b""))
        else:
            transport.send(sender, read_tag(rid),
                           encode_reply(rid, ST_OK, ans[0], ans[1]))
        return True
    if grade == GRADE_STALE:
        # a server-side stale read exists for completeness (the normal
        # stale path never leaves the client); answer from applied state
        kv.reads_stale += 1
        C_READS[GRADE_STALE].inc()
        seq, val = kv.answer(key)
        transport.send(sender, read_tag(rid),
                       encode_reply(rid, ST_OK, seq, val))
        return True
    return False


class PendingRead:
    """One queued linearizable read on the server: released when its
    write barrier drains AND one full serve wave has passed since it
    arrived."""

    __slots__ = ("sender", "rid", "key", "barrier", "wave0")

    def __init__(self, sender: int, rid: int, key: bytes,
                 barrier, wave0: int):
        self.sender = sender
        self.rid = rid
        self.key = key
        self.barrier = barrier
        self.wave0 = wave0

    def ready(self, pending: Dict[int, Any], wave: int) -> bool:
        return wave > self.wave0 and not (self.barrier & pending.keys())


def local_stale_read(mirror: Dict[bytes, Tuple[int, bytes]],
                     key: bytes) -> Tuple[int, bytes]:
    """The client-side stale grade: straight from the decision bank
    mirror, no wire traffic at all."""
    C_READS[GRADE_STALE].inc()
    return mirror.get(key, (0, b""))


def combine_lin(replies) -> Tuple[int, bytes]:
    """Majority-combine rule for linearizable reads: every replying
    replica already reflects all acked writes (the barrier argument in
    the module docstring), so the freshest (max-seq) answer wins."""
    best = (0, b"")
    for seq, val in replies:
        if seq >= best[0]:
            best = (int(seq), bytes(val))
    return best


def majority(n: int) -> int:
    return n // 2 + 1
