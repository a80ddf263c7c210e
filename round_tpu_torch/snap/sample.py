"""Snapshot sampling: the per-replica half of round-consistent cuts.

Port of round_tpu/snap/sample.py: the policy, the wire form, the digest
and the budget are round_tpu's, so a sample (and its ``blob_digest``
bytes) from either package joins a cut in the other.

The HO model's communication-closed rounds are the whole trick
(docs/SNAPSHOTS.md): a replica's state at the END of round r reflects
exactly the rounds 0..r — no in-flight message can straddle the
boundary, because round r's messages are either folded into round r's
update or dropped as late.  So n per-replica samples stamped the SAME
``(instance, round, epoch)`` coordinate ARE a consistent global state,
with no marker protocol, no channel recording, no coordination beyond
the round structure the protocol already runs ("Reducing asynchrony to
synchronized rounds", PAPERS.md).

This module owns the per-replica side:

  * the DETERMINISTIC sampling policy — every replica must sample the
    same (instance, round) pairs or no cut ever assembles, so the policy
    is a pure function of (instance, seed): round r of instance i is
    sampled iff ``r % every_k == jitter(i)``, the per-instance jitter
    spreading sample waves across rounds instead of aligning every
    instance on the same wave;
  * the wire form — a codec-typed dict payload (runtime/codec.py: zero
    pickle, structurally validated on decode) under the new FLAG_SNAP
    oob flag, the (instance, round, epoch) coordinate riding the Tag;
  * the state DIGEST — blake2b over the canonical codec encoding of the
    state rows, banked in every sample so divergence forensics
    (snap/collect.py) can compare replicas' state trajectories without
    shipping full state twice;
  * the byte budget — a token bucket plus the admission signal:
    audit traffic is strictly lower-priority than serving, so a replica
    that is shedding load (or out of budget) SKIPS samples (counted,
    never queued) rather than competing with the decision plane.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time as _time
from typing import List, Optional, Sequence

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.runtime.oob import FLAG_SNAP, Tag

log = get_logger("snap")

_C_SAMPLES = METRICS.counter("snap.samples")
_C_SAMPLE_BYTES = METRICS.counter("snap.sample_bytes")
_C_SKIP_BUDGET = METRICS.counter("snap.skipped_budget")
_C_SKIP_OVERLOAD = METRICS.counter("snap.skipped_overload")
_C_MALFORMED = METRICS.counter("snap.malformed")

# digest width: 16 bytes of blake2b — collision-resistant enough for
# forensics (a divergence detector, not a security boundary), small
# enough to bank per (node, round) without budget pressure
_DIGEST_SIZE = 16


def state_blob(leaves: Sequence[np.ndarray]) -> bytes:
    """The CANONICAL codec encoding of the state rows — the same bytes
    every replica would produce for this state: C-contiguous arrays
    through codec's fixed-header array encoding (dtype code + dims +
    raw data), so dtype and shape are part of the encoding and two
    states encode equal iff their wire forms are byte-identical.

    This blob IS the sample's wire form for the state (encode_sample
    embeds it as one bytes field): the state is encoded ONCE per sample
    and the digest is computed over those exact bytes — the collector
    re-digests the RECEIVED blob directly, so in-flight corruption of
    the actual wire bytes is what the check detects, with no re-encode
    on either side.

    Shapes are preserved exactly (0-d rows stay 0-d — never
    ascontiguousarray here, which promotes scalars to [1]); the codec
    makes its own contiguous copy when a leaf needs one."""
    return codec.encode([np.asarray(x) for x in leaves])


def blob_digest(blob) -> bytes:
    """blake2b-16 over a canonical state blob — the divergence-
    forensics anchor: computed at the emitter, re-verified at the
    collector, and compared across duplicate claims for one coordinate
    (equivocation — one node, two states, one round)."""
    return hashlib.blake2b(bytes(blob),
                           digest_size=_DIGEST_SIZE).digest()


def state_digest(leaves: Sequence[np.ndarray]) -> bytes:
    """Digest of a state given as decoded rows (the local-join path and
    the offline tools; the wire path digests its blob directly)."""
    return blob_digest(state_blob(leaves))


def sample_jitter(inst: int, seed: int, every_k: int) -> int:
    """The per-instance sampling phase: deterministic in (inst, seed) so
    every replica of a cluster (same seed by the harness contract, the
    chaos/value-schedule determinism) picks the SAME rounds, jittered so
    concurrent instances do not all sample on the same wave."""
    h = hashlib.blake2b(b"snap-jitter" + int(inst).to_bytes(8, "little")
                        + int(seed).to_bytes(8, "little", signed=True),
                        digest_size=4).digest()
    return int.from_bytes(h, "little") % max(1, every_k)


@dataclasses.dataclass
class SnapPolicy:
    """When to sample, and how many bytes sampling may spend.

    every_k:  sample round r of instance i iff r % every_k == jitter(i).
    seed:     the cluster seed (shared across replicas — determinism).
    budget_bytes_per_s: token-bucket refill rate; 0 disables the budget.
              The bucket starts FULL (one burst is free) and is sized at
              one second of refill — audit traffic is smoothed, never
              queued.
    """

    every_k: int = 8
    seed: int = 0
    budget_bytes_per_s: int = 256 << 10

    def __post_init__(self):
        if self.every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {self.every_k}")
        self._tokens = float(self.budget_bytes_per_s)
        self._last = _time.monotonic()
        # jitter memo: due() sits on the per-lane per-round serving hot
        # path and the blake2b phase is constant per instance — hash
        # once, not once per round (bounded like the other id maps)
        self._jitter: dict = {}

    def due(self, inst: int, r: int) -> bool:
        j = self._jitter.get(inst)
        if j is None:
            if len(self._jitter) > 8192:
                self._jitter.clear()
            j = self._jitter[inst] = sample_jitter(inst, self.seed,
                                                   self.every_k)
        return r % self.every_k == j

    def _refill(self) -> None:
        now = _time.monotonic()
        self._tokens = min(
            float(self.budget_bytes_per_s),
            self._tokens + (now - self._last) * self.budget_bytes_per_s)
        self._last = now

    def affordable(self, nbytes: int) -> bool:
        """Peek: would ``nbytes`` fit the bucket right now?  No charge —
        the emitter's pre-gate, so a broke bucket skips a sample BEFORE
        paying the state encode (the budget exists to protect serving;
        it must not cost serving the most while refusing)."""
        if self.budget_bytes_per_s <= 0:
            return True
        self._refill()
        return self._tokens >= nbytes

    def spend(self, nbytes: int) -> bool:
        """True when the byte budget covers ``nbytes`` (and charges it);
        False = skip this sample.  Zero-rate budget always allows."""
        if self.budget_bytes_per_s <= 0:
            return True
        self._refill()
        if self._tokens < nbytes:
            return False
        self._tokens -= nbytes
        return True


def encode_sample(node: int, blob: bytes,
                  values: Sequence[int], digest: bytes) -> bytes:
    """The FLAG_SNAP payload: a codec dict — the state rows as ONE
    canonical blob (state_blob — already encoded for the digest, never
    re-encoded), the instance's proposal row (the artifact ``values``
    vector and the auditor's init-snapshot seed), and the emitter-side
    digest over exactly those blob bytes."""
    return codec.encode({
        "node": int(node),
        "state": bytes(blob),
        "values": np.asarray(values, dtype=np.int64),
        "digest": bytes(digest),
    })


def decode_sample(raw) -> Optional[dict]:
    """Parse one FLAG_SNAP payload; None on anything malformed (the
    socket is unauthenticated — garbage is counted and dropped, the
    codec/hostile-wire discipline).  Returns the received state blob
    alongside the decoded rows so the collector can digest the ACTUAL
    wire bytes (in-flight corruption check) without re-encoding."""
    try:
        p = codec.loads(raw)
        node = int(p["node"])
        blob = bytes(p["state"])
        # OWNING copies: the decoded leaves are zero-copy views into
        # the blob; np.array detaches them so a pending part-cut never
        # pins the payload (nor the transport's reused receive buffer)
        state = [np.array(x) for x in codec.decode(blob)]
        values = np.asarray(p["values"], dtype=np.int64)
        digest = bytes(p["digest"])
        if node < 0 or len(digest) != _DIGEST_SIZE or not state:
            raise ValueError("snap sample out of range")
        return {"node": node, "state": state, "values": values,
                "digest": digest, "blob": blob}
    except Exception as e:  # noqa: BLE001 — hostile bytes must not raise
        _C_MALFORMED.inc()
        log.debug("snap: dropping malformed sample: %s", e)
        return None


class SampleEmitter:
    """One replica's sample source: policy + budget + wire-out.

    ``sink`` is either the local SnapCollector (the collector replica
    samples itself with no wire round-trip) or None; non-local samples
    ship to ``collector_pid`` over ``transport`` as FLAG_SNAP frames.
    ``admission`` is the driver's AdmissionControl (or None): while the
    driver sheds load, sampling stops — audit traffic can never starve
    serving."""

    __slots__ = ("node", "policy", "transport", "collector_pid", "sink",
                 "admission", "samples", "sample_bytes", "skipped",
                 "_sendb", "_flushfn", "_unflushed", "_last_payload")

    def __init__(self, node: int, policy: SnapPolicy, transport,
                 collector_pid: int, sink=None, admission=None):
        self.node = node
        self.policy = policy
        self.transport = transport
        self.collector_pid = collector_pid
        self.sink = sink
        self.admission = admission
        self.samples = 0
        self.sample_bytes = 0
        self.skipped = 0
        # samples COALESCE into the per-peer FLAG_BATCH containers the
        # round traffic already ships (send_buffered/flush): a raw
        # per-sample send would interrupt the collector's native pump
        # wait once PER FRAME — the same wake-storm cost rv decision
        # gossip has — while a buffered sample rides the
        # next wave's container and costs one already-happening wake
        self._sendb = getattr(transport, "send_buffered", None)
        self._flushfn = getattr(transport, "flush", None)
        if self._flushfn is None:
            self._sendb = None
        self._unflushed = False
        self._last_payload = 0

    def emit(self, inst: int, r: int, epoch: int,
             leaves: List[np.ndarray], values: Sequence[int]) -> bool:
        """Sample (inst, r) if due under the policy and budget; returns
        True when a sample left this replica (locally or on the wire)."""
        if not self.policy.due(inst, r):
            return False
        if self.admission is not None and self.admission.shedding:
            self.skipped += 1
            _C_SKIP_OVERLOAD.inc()
            return False
        if self.sink is not None:
            # the collector replica's own contribution: no wire, but the
            # SAME digest/values path as a remote sample (one code path
            # for verification — only transport differs)
            self.samples += 1
            _C_SAMPLES.inc()
            # OWNING copies, shapes preserved: the collector holds the
            # rows past this wave, while the driver's leaves are reused
            # in place (np.array, never ascontiguousarray — the latter
            # promotes 0-d rows to [1] and desyncs the wire shape)
            # the cut coordinate space is (inst & 0xFFFF, epoch & 0xFF)
            # — what the Tag carries on the wire — so the local join
            # masks IDENTICALLY or a wrapped id would strand the
            # collector's own row in a slot its peers never match
            self.sink.add_sample(self.node, inst & 0xFFFF, r,
                                 epoch & 0xFF,
                                 [np.array(x) for x in leaves],
                                 np.asarray(values, dtype=np.int64),
                                 state_digest(leaves), local=True)
            return True
        # broke-bucket pre-gate BEFORE the state encode: under sustained
        # refusal the skip must cost ~nothing (the last payload's size
        # is the estimate — sample sizes are stable within a workload;
        # halved so a marginal bucket still reaches the exact check)
        if self._last_payload and not self.policy.affordable(
                self._last_payload // 2):
            self.skipped += 1
            _C_SKIP_BUDGET.inc()
            return False
        blob = state_blob(leaves)
        payload = encode_sample(self.node, blob, values,
                                blob_digest(blob))
        self._last_payload = len(payload)
        if not self.policy.spend(len(payload)):
            self.skipped += 1
            _C_SKIP_BUDGET.inc()
            return False
        tag = Tag(instance=inst & 0xFFFF, round=r, flag=FLAG_SNAP,
                  call_stack=epoch & 0xFF)
        try:
            if self._sendb is not None:
                self._sendb(self.collector_pid, tag, payload)
                self._unflushed = True
            else:
                self.transport.send(self.collector_pid, tag, payload)
        except Exception as e:  # noqa: BLE001 — a dead collector must
            # never cost the serving path more than the skipped sample
            log.debug("snap: sample send failed: %s", e)
            return False
        self.samples += 1
        self.sample_bytes += len(payload)
        _C_SAMPLES.inc()
        _C_SAMPLE_BYTES.inc(len(payload))
        return True

    def flush(self) -> None:
        """Ship any buffered samples.  The drivers' own send waves flush
        the shared per-peer buffers anyway; this covers the idle tail
        (a driver with no send pending must not strand a sample)."""
        if self._unflushed and self._flushfn is not None:
            self._unflushed = False
            try:
                self._flushfn()
            except Exception as e:  # noqa: BLE001 — best-effort
                log.debug("snap: sample flush failed: %s", e)
