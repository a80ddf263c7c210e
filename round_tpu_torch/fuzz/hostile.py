"""Hostile-wire fuzz gate: structure-aware frame mutation against every
layer of the receive path.

Port of round_tpu/fuzz/hostile.py, over the port's codec, transport and
its own build of the native round pump.  The mutator draws from numpy's
seeded generator, so a seed yields round_tpu's frames.

The serving tier's sockets are unauthenticated: any peer (or anything
that can reach the port) can ship arbitrary bytes.  The runtime's
contract — built up through the codec, the native pump and the
overload hardening — is that hostile bytes cost the receiver
NOTHING but a counter tick: no crash, no wedge, no mailbox corruption,
no memory growth, and decisions identical to a run where the hostile
peer said nothing.  This module is the gate that keeps that contract
true: a seeded, structure-aware mutator built on the codec golden
bytes (tests/test_codec.py) hammers

  * the Python codec (``codec.loads``) and the RESTRICTED unpickler
    (``transport.wire_loads``) — ``fuzz_codec``;
  * the FLAG_BATCH container splitter (``HostTransport._split_batch``)
    — ``fuzz_split``;
  * the C round-pump template parser (``rt_pump_feed`` /
    ``rt_pump_insert`` via a live native node) — ``fuzz_pump``;

with byte-level operators that know WHERE the structural bytes live
(``codec.array_layout`` yields the template/hole map, so tag bytes,
dtype codes, counts and dims are corrupted surgically, not just
sprayed): truncation, tag/dtype/count corruption, oversized dims,
container-split lies (lying sub-frame lengths, zero-length frames,
truncated headers), splices, bit flips, pickle-gadget payloads against
the restricted unpickler, and replayed/corrupted tag words.

Accounting contract (the invariant the gate asserts): every injected
frame is either CONSUMED (decoded to a value / split into sub-frames /
ingested by the pump) or REJECTED — and every rejection ticks
``wire.hostile_rejected`` here, on top of whatever layer-local counter
(``wire.batch_malformed``, ``host.malformed``, pump malformed marks)
the production path already keeps.  ``frames == consumed + rejected``
with nothing unaccounted, or the gate fails.

The cluster-level form — a live group member blasting mutated frames
while the survivors' decision logs must stay byte-identical to a run
where it stays silent — lives in tests/test_overload.py, riding
``-m fuzz``/``-m slow`` alongside the ≥10k-frame arm (the tier-1 form
of the gate is the accounting smoke).
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.oob import FLAG_BATCH, FLAG_NORMAL, Tag

_C_HOSTILE = METRICS.counter("wire.hostile_rejected")

_BATCH_HDR = struct.Struct("<QI")   # the golden FLAG_BATCH sub-frame
# header (tests/test_codec.py test_golden_batch_framing_pinned)

# benign pickle-gadget sentinel: the restricted unpickler must REFUSE the
# payload before this is ever called — a set flag is a gate failure
GADGET_FIRED = {"count": 0}


def _gadget():  # pragma: no cover - firing IS the failure
    GADGET_FIRED["count"] += 1
    return None


class _Gadget:
    def __reduce__(self):
        return (_gadget, ())


def exemplar_payloads() -> List[Any]:
    """Clean wire payloads shaped like real round traffic (the codec
    golden-bytes vocabulary: dict/tuple/list containers, every hot
    dtype, scalars, strings, bytes) — the mutation corpus."""
    return [
        {"x": np.arange(4, dtype=np.int32), "y": np.float64(2.5)},
        {"vote": np.int64(3), "ts": np.int32(7),
         "bits": np.zeros(8, dtype=np.uint8)},
        (np.ones((2, 3), dtype=np.float32), np.bool_(True)),
        [np.int8(-1), np.uint16(9), np.float16(0.5)],
        np.arange(16, dtype=np.int64),
        {"k": "value", "b": b"\x00\x01\x02", "n": None},
        np.complex64(1 + 2j),
        {"nested": {"deep": (np.int32(1), [np.uint32(2)])}},
    ]


class HostileMutator:
    """Seeded structure-aware frame mutator.  ``next_frame()`` yields
    (mutated_bytes, operator_name); ``next_container()`` the FLAG_BATCH
    container form.  Deterministic per seed — a failing frame is
    reproducible from (seed, index) alone."""

    def __init__(self, seed: int = 0,
                 corpus: Optional[List[Any]] = None):
        self.rng = np.random.default_rng(seed)
        self.corpus = corpus if corpus is not None else exemplar_payloads()
        self._clean = [codec.encode(p) for p in self.corpus]
        # structural-byte maps where the layout is fixed (array_layout
        # golden contract: template == encoding, holes == raw data)
        self._structs: List[Tuple[bytes, List[Tuple[int, int, int]]]] = []
        for p in self.corpus:
            lay = codec.array_layout(p)
            self._structs.append(lay if lay is not None else None)
        self._ops: List[Tuple[str, Callable[[bytes], bytes]]] = [
            ("truncate", self._op_truncate),
            ("bitflip", self._op_bitflip),
            ("tag_corrupt", self._op_tag),
            ("struct_corrupt", self._op_struct),
            ("count_huge", self._op_count),
            ("dim_oversize", self._op_dim),
            ("splice", self._op_splice),
            ("append_garbage", self._op_append),
            ("random_bytes", self._op_random),
            ("pickle_gadget", self._op_gadget),
        ]

    # -- byte operators ----------------------------------------------------

    def _pick(self) -> bytes:
        return self._clean[int(self.rng.integers(len(self._clean)))]

    def _op_truncate(self, b: bytes) -> bytes:
        if len(b) < 2:
            return b""
        return b[: int(self.rng.integers(1, len(b)))]

    def _op_bitflip(self, b: bytes) -> bytes:
        if not b:
            return b
        out = bytearray(b)
        for _ in range(int(self.rng.integers(1, 9))):
            i = int(self.rng.integers(len(out)))
            out[i] ^= 1 << int(self.rng.integers(8))
        return bytes(out)

    def _op_tag(self, b: bytes) -> bytes:
        """Corrupt the FIRST byte — the node tag the decoder routes on:
        half the time to a VALID-but-wrong codec tag (0xA0..0xAF, the
        structurally-confusing case), else to anything."""
        if not b:
            return b
        out = bytearray(b)
        if self.rng.random() < 0.5:
            out[0] = int(self.rng.integers(0xA0, 0xB0))
        else:
            out[0] = int(self.rng.integers(256))
        return bytes(out)

    def _op_struct(self, b: bytes) -> bytes:
        """Corrupt a STRUCTURAL byte (outside the array-data holes):
        dtype codes, ndim, dims, counts, key lengths — the bytes the C
        parser memcmps.  Falls back to bitflip when this clean frame has
        no fixed layout."""
        idx = self._clean.index(b) if b in self._clean else -1
        lay = self._structs[idx] if idx >= 0 else None
        if lay is None:
            return self._op_bitflip(b)
        tmpl, holes = lay
        in_hole = np.zeros(len(tmpl), dtype=bool)
        for off, nbytes, _leaf in holes:
            in_hole[off:off + nbytes] = True
        cand = np.nonzero(~in_hole)[0]
        if not len(cand):
            return self._op_bitflip(b)
        out = bytearray(b)
        i = int(cand[int(self.rng.integers(len(cand)))])
        out[i] = int(self.rng.integers(256))
        return bytes(out)

    def _op_count(self, b: bytes) -> bytes:
        """Rewrite a container count / string length field to a huge
        value — the classic length-lie allocation attack."""
        out = bytearray(b)
        for i, t in enumerate(out[:-4]):
            if t in (codec.T_DICT, codec.T_TUPLE, codec.T_LIST):
                out[i + 1:i + 5] = int(
                    self.rng.integers(1 << 16, 1 << 31)
                ).to_bytes(4, "little")
                return bytes(out)
        return self._op_bitflip(b)

    def _op_dim(self, b: bytes) -> bytes:
        """Oversize an ARRAY dim (a 4-GiB claim against a 30-byte frame)
        or its ndim byte (> _MAX_NDIM must be refused)."""
        out = bytearray(b)
        for i, t in enumerate(out[:-2]):
            if t == codec.T_ARRAY:
                if self.rng.random() < 0.3:
                    out[i + 2] = int(self.rng.integers(9, 256))  # ndim
                elif i + 7 <= len(out):
                    out[i + 3:i + 7] = int(
                        self.rng.integers(1 << 20, 1 << 32)
                    ).to_bytes(4, "little")
                return bytes(out)
        return self._op_bitflip(b)

    def _op_splice(self, b: bytes) -> bytes:
        other = self._pick()
        i = int(self.rng.integers(max(1, len(b))))
        j = int(self.rng.integers(max(1, len(other))))
        return b[:i] + other[j:]

    def _op_append(self, b: bytes) -> bytes:
        return b + self.rng.bytes(int(self.rng.integers(1, 64)))

    def _op_random(self, b: bytes) -> bytes:
        return self.rng.bytes(int(self.rng.integers(0, 96)))

    def _op_gadget(self, b: bytes) -> bytes:
        """A pickle stream whose __reduce__ would fire a sentinel: the
        restricted unpickler (transport.wire_loads) must refuse it
        BEFORE any code runs.  Half raw, half behind the codec's
        T_PICKLE fallback tag."""
        raw = pickle.dumps(_Gadget())
        if self.rng.random() < 0.5:
            return raw
        return bytes([codec.T_PICKLE]) + raw

    # -- frame / container generators -------------------------------------

    def next_frame(self) -> Tuple[bytes, str]:
        name, op = self._ops[int(self.rng.integers(len(self._ops)))]
        return op(self._pick()), name

    def next_container(self) -> Tuple[bytes, str]:
        """A FLAG_BATCH container with 1..4 sub-frames, then one
        container-level lie: a lying sub-frame length (points past the
        end), a zero-length frame, a truncated trailing header, or a
        mutated sub-payload."""
        frames = []
        for _ in range(int(self.rng.integers(1, 5))):
            body = self._pick()
            tag = Tag(instance=int(self.rng.integers(1, 8)),
                      round=int(self.rng.integers(0, 16)),
                      flag=FLAG_NORMAL)
            frames.append(_BATCH_HDR.pack(
                tag.pack() & 0xFFFFFFFFFFFFFFFF, len(body)) + body)
        buf = bytearray(b"".join(frames))
        kind = ["len_lie", "zero_len", "trunc_hdr", "sub_mutate"][
            int(self.rng.integers(4))]
        if kind == "len_lie" and len(buf) >= 12:
            buf[8:12] = int(self.rng.integers(1 << 16, 1 << 31)
                            ).to_bytes(4, "little")
        elif kind == "zero_len" and len(buf) >= 12:
            buf[8:12] = (0).to_bytes(4, "little")
        elif kind == "trunc_hdr":
            buf += self.rng.bytes(int(self.rng.integers(1, 12)))
        else:
            frame, _n = self.next_frame()
            tag = Tag(instance=1, round=0, flag=FLAG_NORMAL)
            buf += _BATCH_HDR.pack(tag.pack() & 0xFFFFFFFFFFFFFFFF,
                                   len(frame)) + frame
        return bytes(buf), f"container_{kind}"


def _account(stats: Dict[str, Any], op: str, rejected: bool) -> None:
    key = "rejected" if rejected else "consumed"
    stats[key] += 1
    stats["by_op"].setdefault(op, [0, 0])[0 if rejected else 1] += 1
    if rejected:
        _C_HOSTILE.inc()


def fuzz_codec(frames: int = 2000, seed: int = 0) -> Dict[str, Any]:
    """Hammer ``codec.loads`` (which routes non-codec bytes through the
    restricted unpickler) with mutated frames.  Gate: every frame either
    decodes or raises a CLEAN exception (never a crash/hang), the
    pickle-gadget sentinel never fires, and frames == consumed +
    rejected."""
    mut = HostileMutator(seed)
    stats: Dict[str, Any] = {"frames": frames, "consumed": 0,
                             "rejected": 0, "by_op": {}}
    fired0 = GADGET_FIRED["count"]
    for _ in range(frames):
        frame, op = mut.next_frame()
        try:
            codec.loads(frame)
        except Exception:  # noqa: BLE001 — ANY clean raise is a reject
            _account(stats, op, True)
        else:
            _account(stats, op, False)
    stats["gadget_fired"] = GADGET_FIRED["count"] - fired0
    stats["accounted"] = stats["consumed"] + stats["rejected"] == frames
    stats["ok"] = stats["accounted"] and stats["gadget_fired"] == 0
    return stats


def fuzz_split(containers: int = 1000, seed: int = 0) -> Dict[str, Any]:
    """Hammer the FLAG_BATCH splitter with lying containers, then run
    every recovered sub-frame through the codec.  Gate: the splitter
    never raises, never yields a frame extending past the container, and
    containers == consumed + rejected (rejected = the splitter dropped a
    lying suffix, visible via wire.batch_malformed)."""
    from round_tpu_torch.runtime.transport import HostTransport

    mut = HostileMutator(seed)
    malformed = METRICS.counter("wire.batch_malformed")
    stats: Dict[str, Any] = {"frames": containers, "consumed": 0,
                             "rejected": 0, "by_op": {}, "sub_frames": 0,
                             "sub_decoded": 0}
    for _ in range(containers):
        cont, op = mut.next_container()
        rx: List[Tuple[int, Tag, memoryview]] = []
        before = malformed.value
        n = HostTransport._split_batch(1, memoryview(cont), rx)
        assert n == len(rx)
        for _src, _tag, sub in rx:
            stats["sub_frames"] += 1
            try:
                codec.loads(bytes(sub))
                stats["sub_decoded"] += 1
            except Exception:  # noqa: BLE001 — sub-frame garbage is fine
                _C_HOSTILE.inc()
        _account(stats, op, malformed.value > before)
    stats["accounted"] = (stats["consumed"] + stats["rejected"]
                          == containers)
    stats["ok"] = stats["accounted"]
    return stats


def fuzz_pump(frames: int = 2000, seed: int = 0,
              n: int = 4) -> Dict[str, Any]:
    """Hammer the C round-pump template parser (rt_pump_feed /
    rt_pump_insert) on a live native node: a real payload's template is
    registered and a lane armed, then mutated frames are fed as if from
    every peer.  Gate: the native node survives every frame, a template
    MISS never touches the mailbox, a template HIT only ever writes the
    registered hole bytes, and frames == consumed + rejected.  Returns
    ``{"skipped": True}`` without the native library."""
    from round_tpu_torch.runtime.transport import HostTransport, native_available

    if not native_available():
        return {"skipped": True, "ok": True}
    payload = {"x": np.arange(4, dtype=np.int32), "y": np.float64(2.5)}
    clean = codec.encode(payload)
    tmpl, holes = codec.array_layout(payload)
    mut = HostileMutator(seed, corpus=[payload])
    tr = HostTransport(0)
    stats: Dict[str, Any] = {"frames": frames, "consumed": 0,
                             "rejected": 0, "by_op": {}}
    try:
        pump = tr.enable_pump(1, n, 1, 0)
        if pump is None:
            return {"skipped": True, "ok": True}
        stacked = [np.zeros((n, 4), dtype=np.int32),
                   np.zeros((n,), dtype=np.float64)]
        mask = np.zeros((1, n), dtype=np.uint8)
        count = np.zeros((1,), dtype=np.int64)
        pump.set_class(0, 0, tmpl, holes, stacked, mask=mask[0],
                       count=count, per_lane=False)
        pump.open_lane(0, 1)
        rnd = 0
        pump.arm(0, rnd, 0, n + 1, 0, 60_000, 0)
        for i in range(frames):
            if count[0] >= n - 1 or i % 64 == 63:
                # keep the lane armed at a fresh round so template HITS
                # stay possible (a full mailbox dups everything)
                rnd += 1
                pump.arm(0, rnd, 0, n + 1, 0, 60_000, 0)
            frame, op = mut.next_frame()
            sender = int(mut.rng.integers(0, n + 2))  # incl. out-of-range
            tag = Tag(instance=1, round=rnd, flag=FLAG_NORMAL)
            rc = pump.feed(sender, tag, frame)
            if rc == 1:
                _account(stats, op, False)
            else:
                # not consumed natively (template miss / bad sender):
                # the production path would decode + coerce in Python —
                # here the reject IS the accounting
                _account(stats, op, True)
        # the registered mailbox only ever held registered-hole bytes:
        # a clean frame still templates and ingests after the barrage
        pump.arm(0, rnd + 1, 0, n + 1, 0, 60_000, 0)
        rc = pump.feed(1, Tag(instance=1, round=rnd + 1,
                              flag=FLAG_NORMAL), clean)
        stats["clean_after"] = rc == 1 and bool(mask[0, 1])
        np.testing.assert_array_equal(stacked[0][1],
                                      np.arange(4, dtype=np.int32))
    finally:
        tr.close()
    stats["accounted"] = stats["consumed"] + stats["rejected"] == frames
    stats["ok"] = stats["accounted"] and stats.get("clean_after", False)
    return stats


def run_gate(frames: int = 10_000, seed: int = 0) -> Dict[str, Any]:
    """The whole gate: codec + splitter + native pump, frames split
    across the three surfaces.  ``ok`` iff every surface accounted every
    frame and no gadget fired."""
    per = max(1, frames // 3)
    out = {
        "codec": fuzz_codec(per, seed),
        "split": fuzz_split(per, seed + 1),
        # never negative (frames < 3 would hand the remainder -1 to the
        # pump, whose empty loop then fails its own accounting): every
        # surface gets at least one frame
        "pump": fuzz_pump(max(1, frames - 2 * per), seed + 2),
        "hostile_rejected": _C_HOSTILE.value,
    }
    out["ok"] = all(s.get("ok", False) for s in
                    (out["codec"], out["split"], out["pump"]))
    return out
