"""Typed binary wire codec: the hot-path replacement for pickle.

The host wire's payload vocabulary is ALREADY closed: transport.wire_loads
(the restricted unpickler) refuses everything outside numpy arrays/scalars
and plain builtin containers, so every payload a working deployment ever
ships is expressible in a fixed-header binary format — a struct header per
node plus the raw ``tobytes()`` of each array, the Kryo
registered-class-codec role of the reference (utils/serialization; Kryo
writes a class id + field bytes, not a general object graph).

Why not pickle: PERF_MODEL.md's host-wire roofline puts the old path
allocation-bound — ``pickle.dumps(payload)`` builds the full pickle VM
opcode stream (class lookups, reduce tuples, memo table) per message, and
``loads`` replays it, for payloads that are almost always one small int32
array.  The codec writes/reads the same bytes with one ``struct.pack``
per node and decodes arrays as ZERO-COPY ``np.frombuffer`` views into the
receive buffer.

Grammar (one byte tag per node, little-endian fixed-width fields):

    payload  := node
    node     := NONE | TRUE | FALSE
              | INT    i64
              | FLOAT  f64
              | ARRAY  dtype:u8 ndim:u8 dim:u32* raw-bytes
              | TUPLE  count:u32 node*
              | LIST   count:u32 node*
              | DICT   count:u32 (klen:u16 key-utf8 node)*
              | STR    len:u32 utf8
              | BYTES  len:u32 raw
              | PICKLE pickle-bytes        (tagged fallback)

Tag bytes live in 0xA0.. so a codec payload is never mistaken for a
pickle stream (pickle protocol 2+ starts with 0x80): ``loads`` routes on
the first byte — codec frames decode here, anything else goes through the
restricted ``wire_loads``.  Arbitrary/adversarial bytes therefore land in
exactly one of: a CodecError (structural validation below), or
wire_loads' UnpicklingError — never code execution, never a crash the
caller can't contain.

The PICKLE fallback keeps rare non-array pytrees (arbitrary-key dicts,
big ints, exotic leaves) working; ``wire.codec_fallbacks`` counts every
encode that takes it, and the shipped model suite is pinned to zero
(tests/test_codec.py).

Port of round_tpu/runtime/codec.py, byte for byte: the node tags, the
dtype table's codes (bf16 last, only where ``ml_dtypes`` imports) and the
batch framing are round_tpu's, so either package decodes the other's
frames.  The codec is numpy-only: a payload that arrives as torch tensors
is turned into numpy before it gets here (runtime/host.py::to_numpy).
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Optional

import numpy as np

from round_tpu_torch.obs.metrics import METRICS

# encodes that fell back to pickle (rare non-array pytrees; the shipped
# model suite must keep this at zero — docs/OBSERVABILITY.md)
_C_FALLBACKS = METRICS.counter("wire.codec_fallbacks")

# -- node tags (0xA0..: never a valid pickle opcode-stream start) ---------
T_NONE = 0xA0
T_TRUE = 0xA1
T_FALSE = 0xA2
T_INT = 0xA3
T_FLOAT = 0xA4
T_ARRAY = 0xA5
T_TUPLE = 0xA6
T_LIST = 0xA7
T_DICT = 0xA8
T_STR = 0xA9
T_BYTES = 0xAA
T_PICKLE = 0xAF

_CODEC_TAGS = frozenset(range(T_NONE, T_PICKLE + 1))

# Fixed dtype table (code = index).  EXACT vocabulary, like wire_loads'
# class allowlist: a dtype outside it falls back to pickle on encode and
# is a CodecError on decode.  bf16 (ml_dtypes) is appended when present —
# jax ships it, and bf16 payloads do cross the host wire in mixed runs;
# without it (the card's machine) the table ends at complex128, as
# round_tpu's does.
_DTYPES = [
    np.dtype(np.bool_), np.dtype(np.int8), np.dtype(np.int16),
    np.dtype(np.int32), np.dtype(np.int64), np.dtype(np.uint8),
    np.dtype(np.uint16), np.dtype(np.uint32), np.dtype(np.uint64),
    np.dtype(np.float16), np.dtype(np.float32), np.dtype(np.float64),
    np.dtype(np.complex64), np.dtype(np.complex128),
]
try:  # pragma: no cover - environment-dependent
    import ml_dtypes as _ml

    _DTYPES.append(np.dtype(_ml.bfloat16))
except Exception:  # noqa: BLE001 — optional
    pass
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

_MAX_NDIM = 8
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class CodecError(ValueError):
    """Malformed/adversarial codec bytes (length/ndim/dtype/count out of
    range, truncated stream, trailing garbage).  Callers treat it exactly
    like an UnpicklingError: count malformed, drop the message."""


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_into(obj: Any, out: bytearray) -> None:
    """Append the encoding of ``obj`` to ``out`` (the zero-intermediate
    path: HostRunner encodes straight into a pooled scratch buffer, and
    per-destination batch buffers append a memoryview of that)."""
    if obj is None:
        out.append(T_NONE)
    elif obj is True:
        out.append(T_TRUE)
    elif obj is False:
        out.append(T_FALSE)
    elif type(obj) is int:
        if -(1 << 63) <= obj < (1 << 63):
            out.append(T_INT)
            out += _I64.pack(obj)
        else:
            _fallback(obj, out)
    elif type(obj) is float:
        out.append(T_FLOAT)
        out += _F64.pack(obj)
    elif isinstance(obj, (np.ndarray, np.generic)):
        _encode_array(obj, out)
    elif type(obj) is tuple:
        out.append(T_TUPLE)
        out += _U32.pack(len(obj))
        for x in obj:
            encode_into(x, out)
    elif type(obj) is list:
        out.append(T_LIST)
        out += _U32.pack(len(obj))
        for x in obj:
            encode_into(x, out)
    elif type(obj) is dict:
        if all(type(k) is str for k in obj):
            pos = len(out)
            out.append(T_DICT)
            out += _U32.pack(len(obj))
            for k, v in obj.items():
                kb = k.encode()
                if len(kb) > 0xFFFF:  # pathological key: undo, fall back
                    del out[pos:]
                    _fallback(obj, out)
                    return
                out += _U16.pack(len(kb))
                out += kb
                encode_into(v, out)
        else:
            _fallback(obj, out)
    elif type(obj) is str:
        b = obj.encode()
        out.append(T_STR)
        out += _U32.pack(len(b))
        out += b
    elif type(obj) is bytes:
        out.append(T_BYTES)
        out += _U32.pack(len(obj))
        out += obj
    else:
        _fallback(obj, out)


def _encode_array(obj, out: bytearray) -> None:
    arr = np.asarray(obj)
    code = _DTYPE_CODE.get(arr.dtype)
    if code is None or arr.ndim > _MAX_NDIM:
        _fallback(obj, out)
        return
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    out.append(T_ARRAY)
    out.append(code)
    out.append(arr.ndim)
    for d in arr.shape:
        out += _U32.pack(d)
    try:
        out += arr.data  # zero-copy buffer export
    except (ValueError, TypeError):
        # extension dtypes (bf16) refuse the buffer protocol: copy once
        out += arr.tobytes()


def _fallback(obj: Any, out: bytearray) -> None:
    """The tagged pickle escape hatch for payloads outside the binary
    vocabulary.  Still restricted on DECODE (wire_loads), so this never
    widens what adversarial bytes can do — only what honest peers can
    say."""
    _C_FALLBACKS.inc()
    out.append(T_PICKLE)
    out += pickle.dumps(obj)


def encode(obj: Any) -> bytes:
    """One-shot convenience encode (tests, control plane).  The hot path
    uses ``encode_into`` with a pooled buffer instead."""
    out = bytearray()
    encode_into(obj, out)
    return bytes(out)


def is_codec(raw) -> bool:
    """True when ``raw`` starts with a codec node tag (vs. a pickle
    stream) — the one-byte header peek ``loads`` and the InstanceMux
    route on."""
    return len(raw) > 0 and raw[0] in _CODEC_TAGS


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode(raw) -> Any:
    """Decode one payload (bytes/memoryview).  Array leaves come back as
    ZERO-COPY read-only views into ``raw`` — callers that mutate must
    copy (the mailbox assembly copies into its [n, ...] slots anyway).
    Trailing bytes after the root node are a CodecError: a truncation or
    splice must never half-succeed."""
    mv = memoryview(raw)
    obj, off = _decode_node(mv, 0)
    if off != len(mv):
        raise CodecError(f"{len(mv) - off} trailing byte(s) after payload")
    return obj


def loads(raw, fallback=None) -> Any:
    """THE wire deserializer: codec frames decode here, anything else
    (legacy pickle peers, the tagged T_PICKLE fallback) goes through
    ``fallback`` — by default the restricted ``wire_loads``.  Raises
    CodecError/UnpicklingError on garbage; never executes payload code."""
    if is_codec(raw):
        return decode(raw)
    if fallback is None:
        from round_tpu_torch.runtime.transport import wire_loads as fallback
    return fallback(bytes(raw) if not isinstance(raw, bytes) else raw)


def _need(mv: memoryview, off: int, n: int) -> None:
    if off + n > len(mv):
        raise CodecError(
            f"truncated payload: need {n} byte(s) at {off}, have "
            f"{len(mv) - off}")


def _decode_node(mv: memoryview, off: int):
    _need(mv, off, 1)
    tag = mv[off]
    off += 1
    if tag == T_NONE:
        return None, off
    if tag == T_TRUE:
        return True, off
    if tag == T_FALSE:
        return False, off
    if tag == T_INT:
        _need(mv, off, 8)
        return _I64.unpack_from(mv, off)[0], off + 8
    if tag == T_FLOAT:
        _need(mv, off, 8)
        return _F64.unpack_from(mv, off)[0], off + 8
    if tag == T_ARRAY:
        return _decode_array(mv, off)
    if tag in (T_TUPLE, T_LIST):
        _need(mv, off, 4)
        count = _U32.unpack_from(mv, off)[0]
        off += 4
        # a claimed count needs at least one byte per element left: rejects
        # the 4 GiB-element DoS claim before any allocation
        _need(mv, off, count)
        items = []
        for _ in range(count):
            x, off = _decode_node(mv, off)
            items.append(x)
        return (tuple(items) if tag == T_TUPLE else items), off
    if tag == T_DICT:
        _need(mv, off, 4)
        count = _U32.unpack_from(mv, off)[0]
        off += 4
        _need(mv, off, count)
        d = {}
        for _ in range(count):
            _need(mv, off, 2)
            klen = _U16.unpack_from(mv, off)[0]
            off += 2
            _need(mv, off, klen)
            try:
                k = str(mv[off:off + klen], "utf-8")
            except UnicodeDecodeError as e:
                raise CodecError(f"bad dict key utf-8: {e}") from None
            off += klen
            d[k], off = _decode_node(mv, off)
        return d, off
    if tag in (T_STR, T_BYTES):
        _need(mv, off, 4)
        n = _U32.unpack_from(mv, off)[0]
        off += 4
        _need(mv, off, n)
        chunk = mv[off:off + n]
        off += n
        if tag == T_BYTES:
            return bytes(chunk), off
        try:
            return str(chunk, "utf-8"), off
        except UnicodeDecodeError as e:
            raise CodecError(f"bad str utf-8: {e}") from None
    if tag == T_PICKLE:
        from round_tpu_torch.runtime.transport import wire_loads

        return wire_loads(bytes(mv[off:])), len(mv)
    raise CodecError(f"unknown codec tag 0x{tag:02X}")


def _decode_array(mv: memoryview, off: int):
    _need(mv, off, 2)
    code, ndim = mv[off], mv[off + 1]
    off += 2
    if code >= len(_DTYPES):
        raise CodecError(f"unknown dtype code {code}")
    if ndim > _MAX_NDIM:
        raise CodecError(f"ndim {ndim} > {_MAX_NDIM}")
    dt = _DTYPES[code]
    _need(mv, off, 4 * ndim)
    shape = tuple(_U32.unpack_from(mv, off + 4 * i)[0] for i in range(ndim))
    off += 4 * ndim
    count = 1
    for d in shape:
        count *= d
        if count > (1 << 40):  # absurd element-count claim: reject before
            raise CodecError(f"array too large: shape {shape}")  # allocating
    nbytes = count * dt.itemsize
    _need(mv, off, nbytes)
    arr = np.frombuffer(mv[off:off + nbytes], dtype=dt)
    if ndim == 0:
        arr = arr.reshape(())
    else:
        arr = arr.reshape(shape)
    return arr, off + nbytes


# ---------------------------------------------------------------------------
# fixed-layout templates (the native round pump's parse contract)
# ---------------------------------------------------------------------------


def array_layout(obj):
    """The native-pump template for a payload exemplar: (template_bytes,
    holes) where holes = [(offset, nbytes, flat_leaf_index), ...] in
    template order, or None when the payload is outside the closed
    hot-path vocabulary (dict-with-str-keys / tuple / list containers
    over ndarray leaves — exactly what a round's send produces after
    runtime/host.py::to_numpy).

    The contract this encodes (and tests/test_codec.py pins): for a FIXED
    payload signature, ``encode_into`` emits a FIXED byte layout — every
    structural byte (node tags, dtype codes, ndim, dims, counts, dict
    keys) is static, and only the raw array data (the holes) varies.  The
    C parser (native/transport.cpp rt_pump_set_class) therefore validates
    a frame by memcmp of the static regions and ingests it by memcpy of
    the holes into the mailbox slot — one comparison + one copy replace
    the whole Python decode + tree-flatten + astype path.  ``flat_leaf_
    index`` maps each hole to its tree_flatten position (dict keys
    SORTED, the jax convention runtime/host.py::_flatten keeps — encode
    order keeps insertion order, so the two orders differ and must be
    reconciled here), i.e. to the slot
    array the drivers preallocated for that leaf."""
    out = bytearray()
    holes: list = []
    if not _layout_walk(obj, out, holes, []):
        return None
    flat: list = []
    _flat_paths(obj, [], flat)
    index = {path: i for i, path in enumerate(flat)}
    return bytes(out), [(off, nbytes, index[path])
                        for off, nbytes, path in holes]


def _layout_walk(o, out: bytearray, holes: list, path: list) -> bool:
    """Mirror encode_into's traversal, recording each array's data region.
    Returns False on anything the fixed-layout contract cannot cover
    (scalars and bools change tag bytes or data with the VALUE; pickle
    fallbacks have no fixed layout at all)."""
    if isinstance(o, (np.ndarray, np.generic)):
        arr = np.asarray(o)
        code = _DTYPE_CODE.get(arr.dtype)
        if code is None or arr.ndim > _MAX_NDIM:
            return False
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)
        out.append(T_ARRAY)
        out.append(code)
        out.append(arr.ndim)
        for d in arr.shape:
            out += _U32.pack(d)
        off = len(out)
        out += arr.tobytes()
        holes.append((off, arr.nbytes, tuple(path)))
        return True
    if type(o) in (tuple, list):
        out.append(T_TUPLE if type(o) is tuple else T_LIST)
        out += _U32.pack(len(o))
        return all(_layout_walk(x, out, holes, path + [i])
                   for i, x in enumerate(o))
    if type(o) is dict:
        if not all(type(k) is str for k in o):
            return False
        out.append(T_DICT)
        out += _U32.pack(len(o))
        for k, v in o.items():
            kb = k.encode()
            if len(kb) > 0xFFFF:
                return False
            out += _U16.pack(len(kb))
            out += kb
            if not _layout_walk(v, out, holes, path + [k]):
                return False
        return True
    return False


def _flat_paths(o, path: list, acc: list) -> None:
    """Leaf paths in tree_flatten order (dicts by sorted key)."""
    if isinstance(o, (np.ndarray, np.generic)):
        acc.append(tuple(path))
    elif type(o) in (tuple, list):
        for i, x in enumerate(o):
            _flat_paths(x, path + [i], acc)
    elif type(o) is dict:
        for k in sorted(o):
            _flat_paths(o[k], path + [k], acc)


# ---------------------------------------------------------------------------
# scratch-buffer pool
# ---------------------------------------------------------------------------


class Scratch:
    """A reusable encode buffer: ``encode(obj)`` clears + fills the owned
    bytearray and returns a memoryview of the written bytes — ZERO fresh
    allocations on the steady-state hot path (the bytearray keeps its
    capacity across rounds).  One Scratch per HostRunner: the view is
    only valid until the next encode, which is exactly the send-loop
    lifetime (per-destination batch buffers copy out of it)."""

    __slots__ = ("_buf", "_view")

    def __init__(self):
        self._buf = bytearray()
        self._view: Optional[memoryview] = None

    def encode(self, obj: Any) -> memoryview:
        buf = self._buf
        if self._view is not None:
            # release the previous round's export or the bytearray cannot
            # be cleared (a released view raises on ANY use, so a caller
            # that wrongly retained one fails loudly, not corruptly)
            self._view.release()
            self._view = None
        del buf[:]
        encode_into(obj, buf)
        self._view = memoryview(buf)
        return self._view
