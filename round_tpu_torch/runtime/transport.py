"""Host TCP transport over the native library (native/transport.cpp).

This is the real multi-process deployment path: the reference runs one JVM
per replica with Netty TCP channels between them (TcpRuntime.scala:27-232);
here each OS process owns a `HostTransport` backed by the C++ poll-loop
library, and messages keep the reference's shape — the 8-byte Tag of
runtime/oob.py (flag | callStack | instance | round, Tag.scala:22-25)
followed by payload bytes.

The same `Message` objects that flow over the in-process `LocalBus`
(runtime/oob.py) travel here unchanged: `HostBus` implements the LocalBus
surface (send/deliver) over sockets, so a `PoolNode` — decision replay,
lazy join, recovery — works across real processes too.  The lockstep
round-execution path on top of this lives in runtime/host.py.

Hot-path framing (the Netty-tuning parity of the reference: pooled
buffers, registered-class codec, write coalescing):

  * payloads are encoded by the binary codec (runtime/codec.py), not
    pickle — `wire_loads` stays as the tagged fallback decoder;
  * `send_buffered`/`flush` coalesce the frames of one round into ONE
    FLAG_BATCH container per destination (one native send per peer per
    flush, regardless of frame count);
  * `recv` drains the native inbox in ONE ctypes call
    (rt_node_recv_many), copies the whole drain once, and splits
    containers into logical frames by header peek — payload slices are
    memoryviews, never re-copied.

Fault injection does NOT live here: wrap a HostTransport in
runtime/chaos.py's `FaultyTransport` (same send/recv surface) for
deterministic seed-driven drop/duplicate/reorder/delay/corruption
schedules — the host-path analogue of engine/scenarios.py.

Port of round_tpu/runtime/transport.py over the port's own copy of the
native library (round_tpu_torch/native/transport.cpp, byte-identical to
round_tpu's): it builds at first use into ``round_tpu_torch/_build/
libroundnet.so`` with the one ``g++`` line of round_tpu/native/Makefile,
under a cross-process lock, and never reads or builds round_tpu's.  The
frames on the wire are round_tpu's, so the two packages' nodes talk to
each other.
"""

from __future__ import annotations

import collections
import ctypes
import os
import pickle
import struct
import subprocess
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.oob import FLAG_BATCH, Message, Tag

# wire-level instruments (one lock-guarded add per message on a path that
# is already a syscall): the transport's own view of traffic, below the
# runner's semantic host.sends/host.recvs
_C_WIRE_SENT = METRICS.counter("wire.sent_msgs")
_C_WIRE_SENT_B = METRICS.counter("wire.sent_bytes")
_C_WIRE_RECV = METRICS.counter("wire.recv_msgs")
_C_WIRE_RECV_B = METRICS.counter("wire.recv_bytes")
# frame-coalescing instruments (docs/OBSERVABILITY.md): logical frames
# that traveled inside FLAG_BATCH container frames, and the container
# payload bytes — wire.sent_msgs/recv_msgs keep counting LOGICAL frames,
# so batches/frames is the coalescing factor
_C_BATCHES = METRICS.counter("wire.batches")
_C_BATCH_FRAMES = METRICS.counter("wire.batch_frames")
_C_BATCH_BYTES = METRICS.counter("wire.batch_bytes")
# churn instruments (the view subsystem's wire half, runtime/view.py):
# reconnects = channels re-established by the auto-reconnect loop,
# rewires = peer-table swaps applied by a view change
_C_WIRE_RECONNECT = METRICS.counter("wire.reconnects")
_C_WIRE_REWIRE = METRICS.counter("wire.rewires")
# overload instruments (docs/HOST_FAULT_MODEL.md "overload, shedding and
# quarantine"): backpressure = rising edges of the bounded native inbox's
# byte high watermark; peer_pauses = send paths paused after consecutive
# send failures; backpressure_drops = frames dropped-with-count while a
# peer's send path is paused (bounded memory instead of unbounded retry)
_C_BACKPRESSURE = METRICS.counter("wire.backpressure")
_C_PEER_PAUSES = METRICS.counter("wire.peer_pauses")
_C_BP_DROPS = METRICS.counter("wire.backpressure_drops")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_SRC = os.path.join(_PKG_DIR, "native", "transport.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NATIVE_SO = os.path.join(_BUILD_DIR, "libroundnet.so")
# round_tpu/native/Makefile's libroundnet.so recipe (CXXFLAGS as there)
_CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-shared", "-fPIC",
              "-pthread")
_lib = None
_lib_lock = threading.Lock()


class _WireUnpickler(pickle.Unpickler):
    """Restricted unpickler for wire payloads: numpy array/scalar
    RECONSTRUCTION and plain builtin containers ONLY.  A stock
    pickle.loads on attacker bytes EXECUTES attacker code (a __reduce__
    gadget) before any exception guard can contain it — so the
    byzantine-garbage tolerance of the host path starts here, by refusing
    to even look up classes outside the payload vocabulary.  (The
    reference's Kryo is similarly a registered-class deserializer, not
    arbitrary-code.)

    The allowlist is EXACT (module, name) pairs, not module prefixes: the
    numpy namespace itself contains exec gadgets
    (numpy.testing._private.utils.runstring is literally exec;
    numpy.ctypeslib.load_library loads arbitrary shared objects), so a
    prefix match would reopen the hole this class closes."""

    _ALLOWED = frozenset({
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
    })

    def find_class(self, module, name):
        # bytearray is deliberately ABSENT: no legitimate wire payload
        # pickles one (numpy array states are bytes), and a hostile
        # pickle could otherwise build an ndarray BACKED by a bytearray
        # inside a reference cycle — the GC then deallocates the
        # bytearray while its buffer is still exported, an unraisable
        # SystemError per frame (found by fuzz/hostile.py)
        if module == "builtins" and name in (
                "complex", "frozenset", "set", "slice", "range"):
            return super().find_class(module, name)
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"wire payload references forbidden class {module}.{name}"
        )


# opcodes that construct buffer-backed objects WITHOUT any class lookup
# (protocol 5): find_class can't see them, so they are refused by opcode
# pre-scan.  A hostile BYTEARRAY8 stream can otherwise build an ndarray
# BACKED by a bytearray inside a memo cycle — the GC then deallocates the
# bytearray while its buffer is still exported, an unraisable SystemError
# per frame (found by fuzz/hostile.py).
_FORBIDDEN_PICKLE_OPS = frozenset(
    {"BYTEARRAY8", "NEXT_BUFFER", "READONLY_BUFFER"})


def wire_loads(raw: bytes):
    """pickle.loads restricted to the wire-payload vocabulary (see
    _WireUnpickler); raises pickle.UnpicklingError on anything else.
    The stream is opcode-scanned (pickletools.genops — parse only, zero
    execution) BEFORE the unpickler runs: buffer-constructing opcodes
    bypass find_class entirely and are rejected here."""
    import io

    if b"\x96" in raw or b"\x97" in raw or b"\x98" in raw:
        # cheap prefilter: the three forbidden opcodes are these exact
        # bytes, so a clean frame (no 0x96/0x97/0x98 anywhere, the vast
        # majority) skips the pure-Python genops walk entirely; a hit —
        # possibly a false positive inside string/bytes data — pays the
        # exact opcode-level scan
        import pickletools

        try:
            for op, _arg, _pos in pickletools.genops(raw):
                if op.name in _FORBIDDEN_PICKLE_OPS:
                    raise pickle.UnpicklingError(
                        f"wire payload uses forbidden opcode {op.name}")
        except pickle.UnpicklingError:
            raise
        except Exception as e:  # noqa: BLE001 — unparseable stream
            raise pickle.UnpicklingError(
                f"unparseable pickle stream: {e}") from e
    return _WireUnpickler(io.BytesIO(raw)).load()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        # ROUND_TPU_NATIVE_SO points at a prebuilt alternative library
        # (the sanitizer builds: `make san` -> libroundnet-tsan.so /
        # libroundnet-asan.so) and skips the default build entirely
        override = os.environ.get("ROUND_TPU_NATIVE_SO")
        if override:
            lib = ctypes.CDLL(override)
        else:
            lib = ctypes.CDLL(_build_native())
        lib.rt_node_create.restype = ctypes.c_void_p
        lib.rt_node_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rt_node_create_udp.restype = ctypes.c_void_p
        lib.rt_node_create_udp.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rt_node_create_tls.restype = ctypes.c_void_p
        lib.rt_node_create_tls.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p
        ]
        lib.rt_node_port.restype = ctypes.c_int
        lib.rt_node_port.argtypes = [ctypes.c_void_p]
        lib.rt_node_add_peer.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int
        ]
        lib.rt_node_remove_peer.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rt_node_set_id.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rt_node_connected.restype = ctypes.c_int
        lib.rt_node_connected.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rt_node_connect.restype = ctypes.c_int
        lib.rt_node_connect.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int
        ]
        lib.rt_node_send.restype = ctypes.c_int
        # POINTER(c_char), not c_char_p: flush() passes the per-dest batch
        # bytearray via from_buffer (no bytes copy); plain bytes still
        # convert implicitly
        lib.rt_node_send.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_char), ctypes.c_int,
        ]
        lib.rt_node_recv.restype = ctypes.c_int
        lib.rt_node_recv.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.rt_node_recv_many.restype = ctypes.c_int
        lib.rt_node_recv_many.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rt_node_dropped.restype = ctypes.c_uint64
        lib.rt_node_dropped.argtypes = [ctypes.c_void_p]
        # bounded-inbox / backpressure API (overload hardening; tolerate
        # a stale prebuilt .so — the surface then reports no backpressure
        # and the default caps stay native-side)
        try:
            lib.rt_node_backpressure.restype = ctypes.c_int
            lib.rt_node_backpressure.argtypes = [ctypes.c_void_p]
            lib.rt_node_inbox_bytes.restype = ctypes.c_uint64
            lib.rt_node_inbox_bytes.argtypes = [ctypes.c_void_p]
            lib.rt_node_set_inbox_limits.restype = ctypes.c_int
            lib.rt_node_set_inbox_limits.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong,
            ]
            lib._has_bp = True
        except AttributeError:  # pragma: no cover - stale prebuilt .so
            lib._has_bp = False
        # native per-peer send-pause API (the pump-flush mirror of the
        # Python-surface pause below; same stale-.so tolerance)
        try:
            lib.rt_node_send_pause_stats.restype = ctypes.c_int
            lib.rt_node_send_pause_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
            lib.rt_node_set_send_pause.restype = ctypes.c_int
            lib.rt_node_set_send_pause.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib._has_pause = True
        except AttributeError:  # pragma: no cover - stale prebuilt .so
            lib._has_pause = False
        lib.rt_node_stop.argtypes = [ctypes.c_void_p]
        lib.rt_node_destroy.argtypes = [ctypes.c_void_p]
        # round pump API (native round state machine; tolerate an older
        # .so without it — enable_pump then reports unavailable and the
        # drivers keep the Python pump)
        try:
            lib.rt_pump_enable.restype = ctypes.c_int
            lib.rt_pump_enable.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.rt_pump_disable.argtypes = [ctypes.c_void_p]
            lib.rt_pump_set_class.restype = ctypes.c_int
            lib.rt_pump_set_class.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.rt_pump_open_lane.restype = ctypes.c_int
            lib.rt_pump_open_lane.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.rt_pump_close_lane.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_pump_arm.restype = ctypes.c_int
            lib.rt_pump_arm.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
            ]
            lib.rt_pump_arm_many.restype = ctypes.c_int
            lib.rt_pump_arm_many.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char), ctypes.c_int]
            lib.rt_pump_disarm.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_pump_wait.restype = ctypes.c_int
            lib.rt_pump_wait.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.rt_pump_wait_lane.restype = ctypes.c_int
            lib.rt_pump_wait_lane.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.rt_pump_poke.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.rt_pump_feed.restype = ctypes.c_int
            lib.rt_pump_feed.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_char), ctypes.c_int,
            ]
            lib.rt_pump_insert.restype = ctypes.c_int
            lib.rt_pump_insert.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_char), ctypes.c_int,
            ]
            lib.rt_pump_mark_malformed.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.rt_pump_flush.restype = ctypes.c_int
            lib.rt_pump_flush.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char),
                ctypes.POINTER(ctypes.c_char), ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib._has_pump = True
        except AttributeError:  # pragma: no cover - stale prebuilt .so
            lib._has_pump = False
        _lib = lib
        return lib


def _build_native() -> str:
    """The port's libroundnet.so, (re)built when it is missing or older
    than transport.cpp (make's rule), under a cross-PROCESS lock:
    replicas start concurrently (one OS process each) and must not race
    the compiler writing the same .so.  The compiler writes a private
    file that is renamed into place, so a reader never maps a torn
    library."""
    import fcntl

    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".netlock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if (not os.path.exists(_NATIVE_SO) or os.path.getmtime(_NATIVE_SO)
                < os.path.getmtime(_NATIVE_SRC)):
            tmp = f"{_NATIVE_SO}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_CXX_FLAGS,
                            "-o", tmp, _NATIVE_SRC],
                           check=True, capture_output=True)
            os.replace(tmp, _NATIVE_SO)
    return _NATIVE_SO


def native_available() -> bool:
    """True when the native transport library builds/loads in this
    environment — the skip-not-fail guard for toolchain-less CI boxes
    (tests skip native-path suites instead of failing tier-1)."""
    try:
        _load()
        return True
    except Exception:  # noqa: BLE001 — missing toolchain, broken gcc, ...
        return False


class HostTransport:
    """One node of the host runtime: a listening socket + lazy outbound
    connections, sending/receiving Tag+payload frames.

    `port=0` binds an ephemeral port (read it back from `.port` — the test
    harness pattern; fixed ports mirror the reference's XML peer lists,
    Config.scala:6-27).

    `proto="udp"` switches to the datagram transport — the reference's
    default perf transport shape (UdpRuntime.scala:19-96): drop-tolerant,
    no reconnect state, one datagram per message (payloads over ~64 KiB
    fail at send).

    `proto="tls"` runs the framed TCP protocol inside TLS — the
    reference's TCP_SSL mode (TcpRuntime.scala:143-158).  Pass PEM paths
    via `cert_file`/`key_file`, or leave both None for a per-process
    SELF-SIGNED pair (the reference's SelfSignedCertificate fallback,
    RuntimeOptions.scala:51-67).  Matching the reference's insecure-trust
    default for self-signed deployments, peers do NOT verify certificate
    chains: TLS provides channel privacy/integrity, not authentication."""

    def __init__(self, node_id: int, port: int = 0, proto: str = "tcp",
                 cert_file: Optional[str] = None,
                 key_file: Optional[str] = None):
        if proto not in ("tcp", "udp", "tls"):
            raise ValueError(f"proto must be tcp, udp or tls, got {proto!r}")
        self._lib = _load()
        self.id = node_id
        self.proto = proto
        if proto == "tls":
            if (cert_file is None) != (key_file is None):
                raise ValueError("supply both cert_file and key_file, "
                                 "or neither (self-signed fallback)")
            if cert_file is None:
                cert_file, key_file = _self_signed_pair()
            self._node = self._lib.rt_node_create_tls(
                node_id, port, cert_file.encode(), key_file.encode(),
            )
        else:
            create = (self._lib.rt_node_create_udp if proto == "udp"
                      else self._lib.rt_node_create)
            self._node = create(node_id, port)
        if not self._node:
            raise OSError(f"could not bind node {node_id} on port {port}"
                          + (" (TLS: libssl or certificate unavailable)"
                             if proto == "tls" else ""))
        self.port = self._lib.rt_node_port(self._node)
        self._buf = ctypes.create_string_buffer(1 << 20)
        self.closed = False  # set once recv observes the stopped node
        # logical frames already pulled off the native inbox (a batched
        # drain copies EVERY queued native message out in one ctypes call
        # and splits FLAG_BATCH containers by header peek; payload slices
        # are memoryviews into that one immutable copy — zero per-frame
        # copies).  deque ops are atomic under the GIL; concurrent recv
        # callers interleave exactly like they did on the native inbox.
        self._rx: collections.deque = collections.deque()
        # per-destination coalescing buffers: send_buffered() accumulates
        # `u64 tag | u32 len | payload` entries, flush() ships each as ONE
        # FLAG_BATCH wire frame (the Netty write-coalescing role;
        # comm-closure makes round-boundary flushing safe).  The size cap
        # bounds a batch (UDP: a datagram must hold it); the LATENCY cap
        # is structural — HostRunner flushes at every round boundary.
        self.batch_cap = (48 << 10) if proto == "udp" else (1 << 20)
        self._out: Dict[int, list] = {}  # dest -> [bytearray, frame count]
        self._out_lock = threading.Lock()
        # live peer table mirror (pid -> (host, port)): the native layer
        # keeps its own map, but rewire() needs to DIFF old vs new and the
        # reconnect loop needs something to iterate — one lock guards both
        self._peers: Dict[int, Tuple[str, int]] = {}
        self._peers_lock = threading.Lock()
        self.reconnects = 0           # channels re-established by the loop
        self._reconn_stop: Optional[threading.Event] = None
        self._reconn_thread: Optional[threading.Thread] = None
        self._on_reconnect = None     # churn observer (start_reconnect)
        # serializes rewire() against the reconnect loop's dials: a dial
        # that READS a pid's address before rewire and INSTALLS the
        # channel after it would permanently wire that pid to the old
        # replica (observed: a renamed replica's reconnect thread redialed
        # severed peers mid-rewire and resurrected the pre-change mapping)
        self._churn_lock = threading.Lock()
        self._pump: Optional["RoundPump"] = None
        # overload hardening (docs/HOST_FAULT_MODEL.md): per-peer send
        # PAUSE — after `pause_after` consecutive send failures to one
        # peer, sends to it drop-with-count for `pause_ms` instead of
        # re-dialing on every frame (the reconnect loop keeps probing in
        # the background; a successful send or reconnect resumes
        # immediately).  The bookkeeping is deliberately UNLOCKED:
        # every individual dict op is GIL-atomic, and the worst a racing
        # pair of senders can do is under-count a consecutive failure or
        # briefly clear a just-installed pause — either delays the pause
        # by a frame, never corrupts state.  Taking _out_lock here would
        # put a lock acquisition on every hot-path send for a pathology
        # that only matters while a peer is already dead.  The native
        # pump-flush path keeps its own mirror of this pause (transport
        # .cpp send_msg), folded into the same counters by the drain
        # path's _poll_backpressure.
        self.pause_after = 16
        self.pause_ms = 250
        self._send_fails: Dict[int, int] = {}
        self._paused_until: Dict[int, float] = {}
        self.backpressure_events = 0   # rising edges observed (wire.
        self._bp_last = False          # backpressure counts the same)
        self._np_pauses = 0            # native send-pause counters last
        self._np_drops = 0             # folded into METRICS (drain path)

    # the native rt_pump_flush send path may be used on THIS transport —
    # but only while its Python send surface is the stock one: a fault
    # wrapper (chaos.FaultyTransport does not re-export this property), a
    # subclass override, or a monkey-patched send/send_buffered (the
    # loss-injecting test doubles) must keep seeing every frame, so the
    # drivers then stay on the per-frame send_buffered surface
    @property
    def pump_send_ok(self) -> bool:
        return ("send" not in self.__dict__
                and "send_buffered" not in self.__dict__
                and type(self).send_buffered is HostTransport.send_buffered
                and type(self).send is HostTransport.send)

    def enable_pump(self, L: int, n: int, k: int,
                    nbz: int = 0) -> Optional["RoundPump"]:
        """Attach (or reconfigure) the native round pump: L lanes over n
        processes and k round classes.  Returns None — and callers keep
        the Python pump — when the native side lacks the pump API (stale
        prebuilt .so) or ``ROUND_TPU_PUMP=0`` disables it."""
        if os.environ.get("ROUND_TPU_PUMP", "1") == "0":
            return None
        if not self._node or not getattr(self._lib, "_has_pump", False):
            return None
        if self._pump is not None:
            self._pump.close()
        self._pump = RoundPump(self, L, n, k, nbz)
        return self._pump

    def disable_pump(self) -> None:
        if self._pump is not None:
            self._pump.close()
            self._pump = None

    # -- overload / backpressure surface -----------------------------------

    @property
    def backpressure(self) -> bool:
        """True while the native inbox sits above its byte high watermark
        (the level form of the pump's kReadyBackpr reason bit)."""
        if not self._node or not getattr(self._lib, "_has_bp", False):
            return False
        return bool(self._lib.rt_node_backpressure(self._node))

    @property
    def inbox_bytes(self) -> int:
        if not self._node or not getattr(self._lib, "_has_bp", False):
            return 0
        return int(self._lib.rt_node_inbox_bytes(self._node))

    def set_inbox_limits(self, max_msgs: int = 0, max_bytes: int = 0,
                         high: int = 0, low: int = 0) -> bool:
        """Configure the bounded native inbox (0 keeps a value).  The
        ladder low <= high <= max_bytes is enforced natively."""
        if not self._node or not getattr(self._lib, "_has_bp", False):
            return False
        return self._lib.rt_node_set_inbox_limits(
            self._node, max_msgs, max_bytes, high, low) == 0

    def _poll_backpressure(self) -> bool:
        """Edge-detect the native backpressure level into the
        ``wire.backpressure`` counter, and fold the NATIVE send-pause
        counters (pump-flush sends to a dead peer pause inside
        transport.cpp's send_msg) into the shared ``wire.peer_pauses`` /
        ``wire.backpressure_drops`` vocabulary (called from the drain
        path — the only place these can change without us noticing)."""
        cur = self.backpressure
        if cur and not self._bp_last:
            self.backpressure_events += 1
            _C_BACKPRESSURE.inc()
            if TRACE.enabled:
                TRACE.emit("wire_backpressure", node=self.id,
                           inbox_bytes=self.inbox_bytes)
        self._bp_last = cur
        if self._node and getattr(self._lib, "_has_pause", False):
            out = (ctypes.c_ulonglong * 2)()
            self._lib.rt_node_send_pause_stats(self._node, out)
            dp = int(out[0]) - self._np_pauses
            dd = int(out[1]) - self._np_drops
            if dp > 0:
                _C_PEER_PAUSES.inc(dp)
            if dd > 0:
                _C_BP_DROPS.inc(dd)
            self._np_pauses, self._np_drops = int(out[0]), int(out[1])
        return cur

    def _send_paused(self, dest: int) -> bool:
        """True while dest's send path is paused (caller holds _out_lock
        or tolerates a stale read — a stray frame either way)."""
        until = self._paused_until.get(dest)
        if until is None:
            return False
        if _time.monotonic() >= until:
            self._paused_until.pop(dest, None)
            # probe posture past expiry: ONE failed send re-engages the
            # pause (a success clears the count via _note_send)
            self._send_fails[dest] = self.pause_after - 1
            return False
        return True

    def _note_send(self, dest: int, ok: bool) -> None:
        if ok:
            if self._send_fails.pop(dest, 0):
                self._paused_until.pop(dest, None)
            return
        fails = self._send_fails.get(dest, 0) + 1
        self._send_fails[dest] = fails
        if fails >= self.pause_after and dest not in self._paused_until:
            self._paused_until[dest] = _time.monotonic() + self.pause_ms / 1e3
            _C_PEER_PAUSES.inc()
            if TRACE.enabled:
                TRACE.emit("peer_pause", node=self.id, dst=dest,
                           fails=fails, pause_ms=self.pause_ms)

    def resume_peer(self, dest: int) -> None:
        """Clear a peer's send pause (a successful reconnect proves it is
        back — called by the reconnect loop; the NATIVE mirror clears
        itself on any successful dial)."""
        self._send_fails.pop(dest, None)
        self._paused_until.pop(dest, None)

    def set_send_pause(self, after: int = 0, ms: int = 0) -> bool:
        """Configure the NATIVE per-peer send pause (0 keeps a value);
        the Python-surface ``pause_after``/``pause_ms`` fields above are
        an independent mirror guarding the Python send entry points."""
        if not self._node or not getattr(self._lib, "_has_pause", False):
            return False
        return self._lib.rt_node_set_send_pause(self._node, after, ms) == 0

    def add_peer(self, peer_id: int, host: str, port: int) -> None:
        if not self._node:
            return  # closed: nothing to register on
        with self._peers_lock:
            self._peers[peer_id] = (host, port)
        self._lib.rt_node_add_peer(
            self._node, peer_id, host.encode(), port
        )

    def remove_peer(self, peer_id: int) -> None:
        """Forget a peer: sever its channel and drop its address.  The
        reconnect loop stops dialing it; sends to it fail."""
        if not self._node:
            return
        with self._peers_lock:
            self._peers.pop(peer_id, None)
        self._lib.rt_node_remove_peer(self._node, peer_id)

    def connected(self, peer_id: int) -> bool:
        """True when a live channel to the peer exists (UDP: when its
        address is registered — datagrams have no channel state)."""
        if not self._node:
            return False
        return bool(self._lib.rt_node_connected(self._node, peer_id))

    def rewire(self, peers: Dict[int, Tuple[str, int]],
               my_id: Optional[int] = None) -> Dict[str, int]:
        """Swap the live peer table to ``peers`` (pid -> (host, port), our
        own entry skipped) on a RUNNING node — the wire half of a view
        change (TcpRuntime.scala:75-110 rewiring when the group changes).

        Unchanged (pid, address) pairs keep their connections; added peers
        are registered (the reconnect loop or the next send dials them);
        removed pids are severed; a pid whose address changed — which is
        what an id-compaction rename looks like from the outside
        (Replicas.scala:136-142) — is severed and re-registered so the
        fresh channel handshakes under the NEW ids.  ``my_id`` renames
        this node itself — and that severs EVERY existing channel, even to
        address-unchanged peers: their inbound attribution of this node
        was fixed by the handshake at connect time, so a kept channel
        would stamp our frames with the OLD id forever (observed as one
        renamed replica wire-isolated after a remove: its traffic folded
        into another pid's mailbox slot and its catch-up replies routed to
        that other replica).  Returns the {added, removed, readdressed,
        rehandshaked} counts for callers' trace events."""
        stats = {"added": 0, "removed": 0, "readdressed": 0,
                 "rehandshaked": 0}
        if not self._node:
            return stats
        self._churn_lock.acquire()
        try:
            return self._rewire_locked(peers, my_id, stats)
        finally:
            self._churn_lock.release()

    def _rewire_locked(self, peers, my_id, stats):
        renamed = my_id is not None and my_id != self.id
        if renamed:
            self._lib.rt_node_set_id(self._node, my_id)
            self.id = my_id
        with self._peers_lock:
            old = dict(self._peers)
        me = self.id
        for pid in old:
            if pid not in peers or pid == me:
                self.remove_peer(pid)
                stats["removed"] += 1
        for pid, (host, port) in peers.items():
            if pid == me:
                continue
            cur = old.get(pid)
            if cur == (host, port) and not renamed:
                continue
            if cur is not None:
                # sever before re-registering: the old channel either
                # points at a DIFFERENT replica now (readdressed pid) or
                # carries our OLD handshake id (we were renamed) — both
                # mis-attribute every frame sent on them
                self._lib.rt_node_remove_peer(self._node, pid)
                stats["rehandshaked" if cur == (host, port)
                      else "readdressed"] += 1
            else:
                stats["added"] += 1
            self.add_peer(pid, host, port)
        _C_WIRE_REWIRE.inc()
        if TRACE.enabled:
            TRACE.emit("wire_rewire", node=self.id, **stats)
        return stats

    def start_reconnect(self, period_ms: int = 200, backoff: float = 2.0,
                        max_backoff_ms: int = 3200,
                        connect_timeout_ms: int = 250,
                        on_reconnect=None) -> None:
        """Start the periodic auto-reconnect loop: every ``period_ms`` each
        registered peer without a live channel is re-dialed, failures
        backing off exponentially per peer up to ``max_backoff_ms`` (the
        reference redials dead peers on a period, TcpRuntime.scala:
        162-211; without this a peer that only ever LISTENS — it has no
        send to piggyback the redial on — stays dark forever after a
        restart).  Idempotent; stop()/close() ends the loop."""
        if self._reconn_thread is not None and self._reconn_thread.is_alive():
            return
        # optional churn observer (pid -> None), e.g. PeerHealth.
        # note_reconnect: reconnect churn is a health signal
        self._on_reconnect = on_reconnect
        self._reconn_stop = threading.Event()
        self._reconn_thread = threading.Thread(
            target=self._reconnect_loop,
            args=(self._reconn_stop, period_ms / 1000.0, backoff,
                  max_backoff_ms / 1000.0, connect_timeout_ms),
            daemon=True,
        )
        self._reconn_thread.start()

    def _reconnect_loop(self, stop: threading.Event, period: float,
                        backoff: float, max_wait: float,
                        connect_timeout_ms: int) -> None:
        next_try: Dict[int, float] = {}
        wait: Dict[int, float] = {}
        while not stop.wait(period):
            if not self._node or self.closed:
                return
            with self._peers_lock:
                peers = list(self._peers)
            now = _time.monotonic()
            for pid in peers:
                # per-peer churn-lock scope: the check-then-dial must not
                # SPAN a rewire (it would install a channel to the pid's
                # pre-rewire address), but rewire may interleave between
                # peers — a dial blocks it for at most connect_timeout_ms
                with self._churn_lock:
                    with self._peers_lock:
                        if pid not in self._peers:
                            continue  # rewired away since the snapshot
                    if self.connected(pid):
                        next_try.pop(pid, None)
                        wait.pop(pid, None)
                        continue
                    if now < next_try.get(pid, 0.0):
                        continue
                    node = self._node
                    if not node:
                        return
                    ok = self._lib.rt_node_connect(
                        node, pid, connect_timeout_ms) == 0
                if ok:
                    self.reconnects += 1
                    _C_WIRE_RECONNECT.inc()
                    self.resume_peer(pid)  # a live channel ends the pause
                    cb = self._on_reconnect
                    if cb is not None:
                        try:
                            cb(pid)
                        except Exception:  # noqa: BLE001 — an observer
                            pass           # must never kill the loop
                    if TRACE.enabled:
                        TRACE.emit("wire_reconnect", node=self.id, dst=pid)
                    next_try.pop(pid, None)
                    wait.pop(pid, None)
                else:
                    w = min(max_wait, wait.get(pid, period) * backoff)
                    wait[pid] = w
                    next_try[pid] = _time.monotonic() + w

    def send(self, to: int, tag: Tag, payload: bytes = b"") -> bool:
        """False when the peer is unreachable (reconnect is retried on the
        next send, TcpRuntime.scala:162-211 semantics)."""
        if not self._node:
            return False  # closed: a racing late send must not deref the
            # freed native node (crash-restart teardown hardening)
        if self._send_paused(to):
            _C_BP_DROPS.inc()
            return False
        rc = self._lib.rt_node_send(
            self._node, to, tag.pack() & 0xFFFFFFFFFFFFFFFF, bytes(payload)
            if not isinstance(payload, bytes) else payload, len(payload),
        )
        self._note_send(to, rc == 0)
        if rc == 0:
            _C_WIRE_SENT.inc()
            _C_WIRE_SENT_B.inc(len(payload))
        return rc == 0

    # -- frame coalescing (the hot-path send of runtime/host.py) -----------

    def send_buffered(self, to: int, tag: Tag, payload=b"") -> bool:
        """Queue one logical frame for ``to``; it travels inside the next
        flush()'s FLAG_BATCH container (one native send + one syscall for
        every frame queued to that destination since the last flush).
        ``payload`` may be any bytes-like (the hot path hands the SAME
        scratch memoryview to every destination — encode once, copy once
        per destination, no intermediate bytes objects).  A buffer that
        would outgrow ``batch_cap`` is flushed first (UDP: a datagram must
        carry the whole batch).  Returns False when the node is closed."""
        if not self._node:
            return False
        if self._send_paused(to):
            # bounded-memory discipline: a paused peer's frames drop with
            # a count instead of accumulating (re-dial on every frame is
            # exactly what the pause exists to stop)
            _C_BP_DROPS.inc()
            return False
        entry_len = 12 + len(payload)
        with self._out_lock:
            ent = self._out.get(to)
            if ent is None:
                ent = self._out[to] = [bytearray(), 0]
            if ent[1] and len(ent[0]) + entry_len > self.batch_cap:
                self._flush_one(to, ent)
            ent[0] += _BATCH_HDR.pack(tag.pack() & 0xFFFFFFFFFFFFFFFF,
                                      len(payload))
            ent[0] += payload
            ent[1] += 1
        return True

    def flush(self, to: Optional[int] = None) -> int:
        """Ship every buffered frame (or only ``to``'s) as FLAG_BATCH
        container frames — the round-boundary call of HostRunner.  Returns
        the number of logical frames flushed."""
        if not self._node:
            return 0
        total = 0
        with self._out_lock:
            for dest, ent in (self._out.items() if to is None
                              else [(to, self._out.get(to))]):
                if ent is None or not ent[1]:
                    continue
                total += ent[1]
                self._flush_one(dest, ent)
        return total

    def _flush_one(self, dest: int, ent: list) -> None:
        """Send one destination's batch (caller holds _out_lock — sends
        are serialized per destination, preserving frame order).  A
        single queued frame ships as a PLAIN frame — the container only
        pays for itself from two frames up (a sequential round queues
        exactly one frame per peer; the pipelined window and
        retransmission bursts are what coalesce).  The container tag
        carries the frame count in its round field (a recv-side sanity
        cross-check and a free stat)."""
        buf, count = ent
        if count == 1:
            subtag, ln = _BATCH_HDR.unpack_from(buf, 0)
            rc = self._lib.rt_node_send(
                self._node, dest, subtag,
                (ctypes.c_char * ln).from_buffer(buf, 12), ln,
            )
            if rc == 0:
                _C_WIRE_SENT.inc()
                _C_WIRE_SENT_B.inc(ln)
        else:
            tag = Tag(instance=0, round=count, flag=FLAG_BATCH)
            rc = self._lib.rt_node_send(
                self._node, dest, tag.pack() & 0xFFFFFFFFFFFFFFFF,
                (ctypes.c_char * len(buf)).from_buffer(buf), len(buf),
            )
            if rc == 0:
                _C_WIRE_SENT.inc(count)
                _C_WIRE_SENT_B.inc(len(buf) - 12 * count)
                _C_BATCHES.inc()
                _C_BATCH_FRAMES.inc(count)
                _C_BATCH_BYTES.inc(len(buf))
        self._note_send(dest, rc == 0)
        ent[0] = bytearray()
        ent[1] = 0

    # -- receive -----------------------------------------------------------

    def recv(self, timeout_ms: int) -> Optional[Tuple[int, Tag, bytes]]:
        """One logical frame: (sender, tag, payload).  Payloads of frames
        that traveled in a batched drain are memoryviews into the drain's
        single copy (compare equal to bytes; hand to np.frombuffer for
        zero-copy decode)."""
        rx = self._rx
        while True:
            try:
                return rx.popleft()
            except IndexError:
                pass
            if not self._fill(timeout_ms):
                return None
            timeout_ms = 0  # only loop again for an all-garbage drain

    def recv_many(self, timeout_ms: int) -> List[Tuple[int, Tag, bytes]]:
        """Every logical frame currently available, in one batched native
        drain (plus anything already split): the HostRunner/mux drain
        primitive.  Waits up to ``timeout_ms`` only when nothing is
        pending; an empty list means timeout/closed."""
        rx = self._rx
        if not rx:
            self._fill(timeout_ms)
        elif self._node:
            self._fill(0)  # opportunistic: append what is already queued
        out = list(rx)
        rx.clear()
        return out

    def _fill(self, timeout_ms: int) -> bool:
        """One native batched drain into the rx deque: EVERY queued native
        message copies out in ONE ctypes call, FLAG_BATCH containers are
        split by header peek (memoryview slices — payload bytes are never
        re-copied).  False when nothing arrived (timeout/closed)."""
        if not self._node:
            return False
        # edge-count wire.backpressure BEFORE the drain: the pop path
        # clears the level at the low watermark, so polling after would
        # never observe the rising edge it exists to record
        self._poll_backpressure()
        nb = ctypes.c_int()
        k = self._lib.rt_node_recv_many(
            self._node, self._buf, len(self._buf), timeout_ms,
            ctypes.byref(nb),
        )
        if k == 0:
            return False
        if k == -3:  # node stopped: no more messages will ever arrive
            self.closed = True
            return False
        if k == -2:  # grow and retry (message stays queued, so retry with
            # timeout 0: it is returned immediately — a full-timeout retry
            # would let one logical recv block up to 2x the requested
            # deadline and skew HostRunner's round accounting)
            self._buf = ctypes.create_string_buffer(len(self._buf) * 4)
            return self._fill(0)
        mv = memoryview(ctypes.string_at(self._buf, nb.value))
        rx = self._rx
        off = 0
        frames = payload_b = 0
        for _ in range(k):
            from_id, tagw, ln = _RECV_HDR.unpack_from(mv, off)
            off += 16
            payload = mv[off:off + ln]
            off += ln
            word = _to_signed64(tagw)
            if (word & 0xFF) == FLAG_BATCH:
                n_sub = self._split_batch(from_id, payload, rx)
                frames += n_sub
                payload_b += len(payload) - 12 * n_sub
            else:
                rx.append((from_id, Tag.unpack(word), payload))
                frames += 1
                payload_b += ln
        if frames:
            _C_WIRE_RECV.inc(frames)
            _C_WIRE_RECV_B.inc(payload_b)
        return True

    @staticmethod
    def _split_batch(from_id: int, mv, rx) -> int:
        """Split one FLAG_BATCH container into logical frames by header
        peek (no payload copy — sub-slices of the drain's memoryview).
        A malformed container (truncated header/length from a byzantine
        peer; honest senders can't produce one) keeps its parseable
        prefix and drops the rest — the per-message garbage tolerance of
        this wire, applied at the framing layer."""
        off, end = 0, len(mv)
        n = 0
        while off + 12 <= end:
            subtag, ln = _BATCH_HDR.unpack_from(mv, off)
            off += 12
            if off + ln > end:
                METRICS.counter("wire.batch_malformed").inc()
                return n
            rx.append((from_id, Tag.unpack(_to_signed64(subtag)),
                       mv[off:off + ln]))
            off += ln
            n += 1
        if off != end:  # trailing bytes shorter than a sub-frame header
            METRICS.counter("wire.batch_malformed").inc()
        return n

    @property
    def dropped(self) -> int:
        if not self._node:
            return 0  # closed (see send)
        return int(self._lib.rt_node_dropped(self._node))

    def stop(self) -> None:
        """Stop the node without freeing it: blocked recv() calls in other
        threads return None (and flag `closed`) so they can unwind before
        close() frees the native object.  Idempotent."""
        self._stop_reconnect()
        if self._node:
            self._lib.rt_node_stop(self._node)

    def _stop_reconnect(self) -> None:
        if self._reconn_stop is not None:
            self._reconn_stop.set()
        t = self._reconn_thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._reconn_thread = None

    def close(self) -> None:
        """Free the node.  Callers with receiver threads must stop() and
        join them first (tests/test_host.py::test_lock_manager_service is
        the pattern)."""
        self._stop_reconnect()
        if self._node:
            self.disable_pump()
            self._lib.rt_node_stop(self._node)
            self._lib.rt_node_destroy(self._node)
            self._node = None
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RoundPump:
    """Python handle on the NATIVE round pump (native/transport.cpp
    rt_pump_*): the per-round receive state machine — FLAG_BATCH split,
    codec-template parse, in-place mailbox fill, arrival bitmasks,
    deadline bookkeeping — runs inside the transport event loop with no
    GIL held, and the round loop blocks in ONE call (`wait`) per round wave.

    The pump exposes SHARED numpy buffers by pointer: ``max_rnd`` [L, n]
    and ``next_round`` [L] (the catch-up bookkeeping the drivers used to
    maintain per message), and ``stats`` (folded into the ``pump.*``
    metrics by :meth:`bank_metrics`).  Mailbox buffers are registered per
    (lane, round-class) via :meth:`set_class` — they are the drivers' own
    preallocated arrays, written natively only while the lane is ARMED.

    Obtain one via ``HostTransport.enable_pump`` (or through
    ``FaultyTransport``, which delegates when its fault plan has no
    receiver-side families).  ``None`` from those calls means the pump is
    unavailable (older .so, ``ROUND_TPU_PUMP=0``) and callers keep the
    Python pump — the automatic-fallback contract."""

    # arm flags (native kPump*)
    F_GROWTH, F_EXTEND, F_STRICT = 1, 2, 4
    # ready reasons (native kReady*)
    R_THRESH, R_GROWTH, R_SKEW, R_DEADLINE, R_POKE = 1, 2, 4, 8, 16
    R_BACKPR = 32  # inbox byte high watermark: the waiter must drain
    R_ROUND_END = R_THRESH | R_SKEW | R_DEADLINE  # default auto-disarm set

    _ARM = struct.Struct("<iiiqIiiB")
    _ENTRY = struct.Struct("<iQII")
    _LEAF = struct.Struct("<QI")
    _HOLE = struct.Struct("<III")

    def __init__(self, transport: "HostTransport", L: int, n: int, k: int,
                 nbz: int = 0):
        self._tr = transport
        self._lib = transport._lib
        self.L, self.n, self.k, self.nbz = L, n, k, nbz
        self.max_rnd = np.full((L, n), -1, dtype=np.int64)
        self.next_round = np.zeros((L,), dtype=np.int64)
        self.stats = np.zeros(16, dtype=np.uint64)
        self._banked = np.zeros(16, dtype=np.uint64)
        self.reasons = np.zeros(L, dtype=np.uint8)
        self._misc = ctypes.c_int()
        self._flush_stats = np.zeros(5, dtype=np.uint64)
        # registered mailbox arrays, pinned against GC: the native side
        # holds RAW pointers into them for the pump's lifetime
        self._pinned: list = []
        rc = self._lib.rt_pump_enable(
            transport._node, L, n, k, nbz,
            self.max_rnd.ctypes.data, self.next_round.ctypes.data,
            self.stats.ctypes.data)
        if rc != 0:
            raise OSError(f"rt_pump_enable failed (rc={rc})")

    def _node(self):
        node = self._tr._node
        if not node:
            raise RuntimeError("transport closed under the pump")
        return node

    def set_class(self, lane: int, cls: int, template: bytes, holes,
                  leaf_arrays, lane_index: int = 0, mask=None,
                  count=None, per_lane: bool = False) -> None:
        """Register one (lane, class) slot.  ``leaf_arrays`` are the
        driver's preallocated mailbox arrays in tree_flatten leaf order —
        ``[n, ...]`` (per_lane=False: a per-instance runner's own
        mailbox, mask ``[n]``, count ``[1]``) or ``[L, n, ...]``
        (per_lane=True: the lane driver's class box, row ``lane_index``,
        mask ``[L, n]``, count ``[L]``)."""
        leaves = bytearray()
        for arr in leaf_arrays:
            row_nbytes = arr.nbytes // arr.shape[0]
            if per_lane:
                base = arr.ctypes.data + lane_index * row_nbytes
                nbytes = row_nbytes // self.n
            else:
                base = arr.ctypes.data
                nbytes = row_nbytes
            leaves += self._LEAF.pack(base, nbytes)
        hb = bytearray()
        for off, nbytes, leaf in holes:
            hb += self._HOLE.pack(off, nbytes, leaf)
        if per_lane:
            mask_addr = mask.ctypes.data + lane_index * mask.shape[1]
            count_addr = count.ctypes.data + lane_index * 8
        else:
            mask_addr = mask.ctypes.data
            count_addr = count.ctypes.data
        self._pinned.append((mask, count, tuple(leaf_arrays)))
        rc = self._lib.rt_pump_set_class(
            self._node(), lane, cls,
            (ctypes.c_char * len(template)).from_buffer_copy(template),
            len(template),
            (ctypes.c_char * len(hb)).from_buffer(hb), len(hb) // 12,
            (ctypes.c_char * len(leaves)).from_buffer(leaves),
            len(leaves) // 12, mask_addr, count_addr)
        if rc != 0:
            raise ValueError("rt_pump_set_class rejected the registration")

    def open_lane(self, lane: int, iid: int) -> None:
        self.max_rnd[lane] = -1
        self.next_round[lane] = 0
        self._lib.rt_pump_open_lane(self._node(), lane, iid & 0xFFFF)

    def close_lane(self, lane: int) -> None:
        self._lib.rt_pump_close_lane(self._node(), lane)

    def arm(self, lane: int, rnd: int, cls: int, threshold: int,
            flags: int = 0, deadline_ms: int = 0, extend_ms: int = 0,
            auto_disarm: Optional[int] = None) -> None:
        self._lib.rt_pump_arm(
            self._node(), lane, rnd, cls, threshold, flags, deadline_ms,
            extend_ms,
            self.R_ROUND_END if auto_disarm is None else auto_disarm)

    def arm_specs(self, specs: bytearray, count: int) -> None:
        """Batched arm — one crossing per send wave.  ``specs`` is
        ``count`` packed ``_ARM`` records (lane, round, cls, threshold,
        flags, deadline_ms, extend_ms, auto_disarm)."""
        rc = self._lib.rt_pump_arm_many(
            self._node(), (ctypes.c_char * len(specs)).from_buffer(specs),
            count)
        if rc != 0:
            raise ValueError("rt_pump_arm_many rejected a spec")

    def disarm(self, lane: int) -> None:
        self._lib.rt_pump_disarm(self._node(), lane)

    def wait(self, timeout_ms: int) -> Tuple[int, bool]:
        """Block until a lane is ready, misc inbox traffic arrived, or
        the timeout; reasons land in ``self.reasons`` (consumed bits —
        round-ending reasons disarm atomically).  Returns
        (ready_lane_count, misc).  -3 (node stopped) returns (-1, False)
        so callers unwind."""
        rc = self._lib.rt_pump_wait(
            self._node(), self.reasons.ctypes.data, timeout_ms,
            ctypes.byref(self._misc))
        if rc == -3:
            return -1, False
        return rc, bool(self._misc.value)

    def wait_lane(self, lane: int, timeout_ms: int) -> int:
        """Single-lane wait (mux runners): the lane's consumed reason
        bits, 0 on timeout, -3 once the node stopped."""
        return self._lib.rt_pump_wait_lane(self._node(), lane, timeout_ms)

    def poke(self, lane: int) -> None:
        self._lib.rt_pump_poke(self._node(), lane)

    def feed(self, sender: int, tag: Tag, raw) -> int:
        """Run one frame through the native state machine from Python
        (stash replay, inbox-fallback re-routing): 1 consumed, 0 not
        pump-routable, -2 template miss at the armed current round."""
        b = raw if isinstance(raw, bytes) else bytes(raw)
        return self._lib.rt_pump_feed(
            self._node(), sender, tag.pack() & 0xFFFFFFFFFFFFFFFF,
            b, len(b))

    def insert(self, lane: int, sender: int, encoded: bytes) -> int:
        """Template-checked canonical insert under the pump lock (the
        bilingual fallback after a Python decode): 1 grew, 0 duplicate,
        -1 structural mismatch."""
        return self._lib.rt_pump_insert(
            self._node(), lane, sender, encoded, len(encoded))

    def mark_malformed(self, lane: int, sender: int) -> None:
        self._lib.rt_pump_mark_malformed(self._node(), lane, sender)

    def flush(self, base, entries: bytearray, count: int) -> int:
        """Ship one send wave: ``entries`` = ``count`` packed ``_ENTRY``
        records (dest, tag, off, len) into ``base`` (the wave's
        encode-once buffer).  One ctypes crossing coalesces per-peer
        FLAG_BATCH containers and does every syscall natively; wire.*
        counters are fed from the returned stats."""
        node = self._tr._node
        if not node:
            return 0
        frames = self._lib.rt_pump_flush(
            node, (ctypes.c_char * len(base)).from_buffer(base),
            (ctypes.c_char * len(entries)).from_buffer(entries), count,
            self._tr.batch_cap, self._flush_stats.ctypes.data)
        st = self._flush_stats
        if frames > 0:
            _C_WIRE_SENT.inc(int(st[0]))
            _C_WIRE_SENT_B.inc(int(st[1]))
            if st[2]:
                _C_BATCHES.inc(int(st[2]))
                _C_BATCH_FRAMES.inc(int(st[3]))
                _C_BATCH_BYTES.inc(int(st[4]))
        return frames

    # -- observability ------------------------------------------------------

    _STAT_NAMES = (
        "pump.fast_frames", "pump.dup_frames", "pump.pending_buffered",
        "pump.pending_applied", "pump.fallbacks", "pump.late_drops",
        "pump.malformed", "pump.waits", "pump.ready_wakes",
        "pump.misc_wakes", "pump.batches_split", "pump.batch_malformed",
    )

    def delta(self) -> np.ndarray:
        """Native stat deltas since the last bank_metrics() call."""
        return (self.stats - self._banked).astype(np.int64)

    def bank_metrics(self) -> np.ndarray:
        """Fold the native stat deltas into the unified ``pump.*``
        counters (docs/OBSERVABILITY.md); returns the deltas."""
        d = self.delta()
        for i, name in enumerate(self._STAT_NAMES):
            if d[i]:
                METRICS.counter(name).inc(int(d[i]))
        self._banked = self.stats.copy()
        return d

    def close(self) -> None:
        node = self._tr._node
        if node:
            self._lib.rt_pump_disable(node)


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# batched-drain record header (native/transport.cpp rt_node_recv_many:
# i32 from | u64 tag | u32 len, memcpy'd field-by-field — little-endian
# standard sizes match the x86-64 layout exactly) and the FLAG_BATCH
# sub-frame header (u64 tag | u32 len)
_RECV_HDR = struct.Struct("<iQI")
_BATCH_HDR = struct.Struct("<QI")


_SELF_SIGNED: Optional[Tuple[str, str]] = None
_self_signed_lock = threading.Lock()


def _self_signed_pair() -> Tuple[str, str]:
    """Generate (once per process) a self-signed cert+key for TLS mode —
    the reference's SelfSignedCertificate fallback (TcpRuntime.scala:
    143-149).  Uses the openssl CLI (the runtime library is present in
    this environment, its dev headers are not)."""
    global _SELF_SIGNED
    with _self_signed_lock:
        if _SELF_SIGNED is not None:
            return _SELF_SIGNED
        import tempfile

        d = tempfile.mkdtemp(prefix="round_tpu_tls_")
        cert, key = os.path.join(d, "cert.pem"), os.path.join(d, "key.pem")
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", key, "-out", cert, "-days", "2",
             "-subj", "/CN=round_tpu"],
            check=True, capture_output=True,
        )
        _SELF_SIGNED = (cert, key)
        return _SELF_SIGNED


class HostBus:
    """LocalBus surface over HostTransport: Message objects (runtime/oob.py)
    cross process boundaries with their Tag on the wire and the payload in
    the binary wire codec (runtime/codec.py; the Kryo role,
    utils/serialization in the reference — pytree payloads on the hot path
    never come through here; this is the control plane: decisions, probes,
    recovery).  Delivery decodes codec AND legacy pickle frames
    (codec.loads auto-detects), so mixed-version peers interoperate."""

    def __init__(self, transport: HostTransport):
        self.transport = transport
        self.node = None  # PoolNode, set by register()
        self.malformed = 0  # garbage wire payloads dropped (never a crash)

    def register(self, node) -> None:
        self.node = node
        node.bus = self

    def send(self, to: int, msg: Message) -> None:
        from round_tpu_torch.runtime import codec

        self.transport.send(to, msg.tag, codec.encode(msg.payload))

    def deliver(self, node_id: Optional[int] = None,
                limit: Optional[int] = None, timeout_ms: int = 0) -> int:
        """Drain received messages into the registered node's
        default_handler (LocalBus.deliver semantics: a handler error does
        not discard the rest of the batch).  `node_id` is accepted for
        LocalBus signature compatibility — a HostBus has exactly one node."""
        from round_tpu_torch.runtime import codec

        count = 0
        first_err: Optional[Exception] = None
        while limit is None or count < limit:
            got = self.transport.recv(timeout_ms if count == 0 else 0)
            if got is None:
                break
            from_id, tag, raw = got
            try:
                payload = codec.loads(raw) if raw else None
            except Exception:  # noqa: BLE001 — a garbage datagram on the
                # unauthenticated socket must never kill the control plane
                # (InstanceHandler.scala:392-399 tolerance); wire_loads also
                # refuses code-execution gadget classes outright
                self.malformed += 1
                continue
            count += 1
            try:
                self.node.default_handler(
                    Message(tag=tag, sender=from_id, payload=payload)
                )
            except Exception as e:  # noqa: BLE001 - per-message isolation
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return count
